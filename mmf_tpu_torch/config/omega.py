"""Minimal OmegaConf-like config engine (no external dependency).

Copied from ``mmf_tpu/config/omega.py``, which is framework free, so
the port reads the same YAML trees with the same semantics; a
``ConfigNode`` also pickles here (the loader's workers need it).

Implements the subset of OmegaConf the reference relies on
(mmf/utils/configuration.py): nested attr-dict nodes, recursive merge,
``${...}`` interpolation with custom resolvers, dotlist overrides with
``key.sub=value`` and ``key[0]=value`` array syntax, struct freeze/defrost,
and YAML round-tripping.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Callable, Dict, List, Optional, Union

import yaml

_RESOLVERS: Dict[str, Callable] = {}

MISSING = "???"


# PyYAML's default YAML-1.1 implicit resolvers mangle config values:
# "1.0_2020_05_19" (a zoo version) parses as the float 1.020200519,
# "2020_05_08" as an int, and dates become datetime objects. OmegaConf
# patches its loader the same way; we re-register strict (no-underscore,
# no-sexagesimal) number resolvers and drop the timestamp resolver so
# such scalars stay strings.
class _StrictScalarLoader(yaml.SafeLoader):
    pass


_StrictScalarLoader.yaml_implicit_resolvers = {
    first: [
        (tag, regexp)
        for tag, regexp in resolvers
        if tag
        not in (
            "tag:yaml.org,2002:float",
            "tag:yaml.org,2002:int",
            "tag:yaml.org,2002:timestamp",
        )
    ]
    for first, resolvers in yaml.SafeLoader.yaml_implicit_resolvers.items()
}
_StrictScalarLoader.add_implicit_resolver(
    "tag:yaml.org,2002:int",
    re.compile(
        r"""^(?:[-+]?0b[0-1]+
            |[-+]?0o?[0-7]+
            |[-+]?(?:0|[1-9][0-9]*)
            |[-+]?0x[0-9a-fA-F]+)$""",
        re.X,
    ),
    list("-+0123456789"),
)
_StrictScalarLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9]*)\.[0-9]*(?:[eE][-+]?[0-9]+)?
            |[-+]?\.[0-9]+(?:[eE][-+]?[0-9]+)?
            |[-+]?[0-9]+(?:[eE][-+]?[0-9]+)
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def yaml_load(stream):
    """yaml.safe_load with config-safe scalar resolution (see above)."""
    return yaml.load(stream, Loader=_StrictScalarLoader)


def register_resolver(name: str, fn: Callable, replace: bool = False):
    if name in _RESOLVERS and not replace:
        return
    _RESOLVERS[name] = fn


# built-in: ${oc.env:VAR,default} / ${env:VAR,default}
def _env_resolver(var, default=None):
    return os.environ.get(var, default)


register_resolver("oc.env", _env_resolver)
register_resolver("env", _env_resolver)


class ConfigNode(dict):
    """Nested dict with attribute access, struct-freeze, and interpolation.

    Freeze state and the interpolation root live on the instance (slots),
    NOT in id()-keyed module dicts — id-keyed globals both leak every
    node ever created and can resolve a fresh node's interpolations
    against a dead config when CPython reuses the id."""

    __slots__ = ("_omega_frozen", "_omega_root", "__weakref__")

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        object.__setattr__(self, "_omega_frozen", False)
        object.__setattr__(self, "_omega_root", None)
        if data:
            for k, v in data.items():
                super().__setitem__(k, _wrap(v))

    # -- mutation guards --------------------------------------------------
    def _check_frozen(self, key):
        if self._omega_frozen:
            raise AttributeError(
                f"Config is frozen (struct mode); cannot modify key '{key}'. "
                "Call defrost() first."
            )

    def __setitem__(self, key, value):
        self._check_frozen(key)
        super().__setitem__(key, _wrap(value))

    def __setattr__(self, key, value):
        if key in ConfigNode.__slots__:
            object.__setattr__(self, key, value)
            return
        self[key] = value

    def __getattr__(self, key):
        if key.startswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"Key '{key}' not in config. Keys: {list(self.keys())}")

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, str) and "${" in value:
            return _resolve_str(value, self._omega_root or self)
        return value

    def __delattr__(self, key):
        self._check_frozen(key)
        del self[key]

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __deepcopy__(self, memo):
        node = ConfigNode()
        for k in super().keys():
            raw = super().__getitem__(k)
            super(ConfigNode, node).__setitem__(k, copy.deepcopy(raw, memo))
        _reroot(node, self._omega_root and node or None)
        return node

    def __reduce__(self):
        # the loader's worker processes receive the dataset's config by
        # pickle (JAX's copy calls a to_dict that does not exist)
        return (_rebuild_confignode, (to_container(self),))


def _rebuild_confignode(d):
    return ConfigNode(d)


def _wrap(value):
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _reroot(node: ConfigNode, root: Optional[ConfigNode]):
    """Record the root for interpolation lookups on every nested node."""
    if root is None:
        root = node
    object.__setattr__(node, "_omega_root", root)
    for k in dict.keys(node):
        v = dict.__getitem__(node, k)
        if isinstance(v, ConfigNode):
            _reroot(v, root)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, ConfigNode):
                    _reroot(item, root)


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: ConfigNode, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, ConfigNode) and part in cur:
            cur = cur[part]
        elif isinstance(cur, list) and part.isdigit():
            cur = cur[int(part)]
        else:
            raise KeyError(dotted)
    return cur


_IN_FLIGHT: set = set()


def _resolve_expr(expr: str, root: ConfigNode):
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in _RESOLVERS:
            args = [a.strip() for a in argstr.split(",")] if argstr.strip() else []
            args = [None if a == "null" else a for a in args]
            return _RESOLVERS[name](*args)
    token = (id(root), expr)
    if token in _IN_FLIGHT:
        raise ValueError(f"Interpolation cycle detected at '${{{expr}}}'")
    _IN_FLIGHT.add(token)
    try:
        return _lookup(root, expr)
    finally:
        _IN_FLIGHT.discard(token)


def _resolve_str(value: str, root: ConfigNode, _depth: int = 0):
    if _depth > 16:
        raise ValueError(
            f"Interpolation cycle or excessive nesting while resolving {value!r}"
        )
    # full-string interpolation returns the raw resolved value (any type)
    m = _INTERP_RE.fullmatch(value.strip())
    if m:
        try:
            resolved = _resolve_expr(m.group(1), root)
        except KeyError:
            return value
        if isinstance(resolved, str) and "${" in resolved:
            return _resolve_str(resolved, root, _depth + 1)
        return resolved

    def sub(match):
        try:
            r = _resolve_expr(match.group(1), root)
        except KeyError:
            return match.group(0)
        return "" if r is None else str(r)

    prev = None
    while prev != value and "${" in value:
        prev = value
        value = _INTERP_RE.sub(sub, value)
    return value


# ---------------------------------------------------------------------------
# public OmegaConf-like API
# ---------------------------------------------------------------------------
def create(data: Union[dict, list, str, None] = None) -> Any:
    if data is None:
        data = {}
    if isinstance(data, str):
        data = yaml_load(data) or {}
    node = _wrap(data)
    if isinstance(node, ConfigNode):
        _reroot(node, None)
    return node


def load(path: str) -> ConfigNode:
    with open(path) as f:
        data = yaml_load(f) or {}
    node = ConfigNode(data)
    _reroot(node, None)
    return node


def merge(*configs) -> ConfigNode:
    """Recursive right-biased merge; dicts merge deep, everything else
    overwrites (matches OmegaConf.merge semantics used by the reference)."""
    out = ConfigNode()
    for cfg in configs:
        if cfg is None:
            continue
        if not isinstance(cfg, (dict,)):
            raise TypeError(f"Cannot merge {type(cfg)}")
        _merge_into(out, cfg)
    _reroot(out, None)
    return out


def _merge_into(dst: ConfigNode, src: dict):
    for k in dict.keys(src):
        sv = dict.__getitem__(src, k) if isinstance(src, ConfigNode) else src[k]
        if (
            k in dst
            and isinstance(dict.__getitem__(dst, k), ConfigNode)
            and isinstance(sv, dict)
        ):
            _merge_into(dict.__getitem__(dst, k), sv)
        else:
            dict.__setitem__(dst, k, copy.deepcopy(_wrap(sv)))


_DOTLIST_ARR_RE = re.compile(r"^(.*)\[(\d+)\]$")


def merge_with_dotlist(cfg: ConfigNode, opts: List[str],
                       strict: bool = True) -> ConfigNode:
    """Apply ``a.b.c=value`` / ``a.b[0]=value`` overrides in place.

    Mirrors reference configuration.py:165-256 including the pairwise
    ``key value`` fallback form.
    """
    if opts is None:
        return cfg
    if len(opts) == 0:
        return cfg

    # support both "key=value" and alternating ["key", "value"] forms
    has_equal = opts[0].find("=") != -1
    if has_equal:
        pairs = [opt.split("=", 1) for opt in opts]
    else:
        if len(opts) % 2 != 0:
            raise RuntimeError("Number of opts should be multiple of 2")
        pairs = [(opts[i], opts[i + 1]) for i in range(0, len(opts), 2)]

    for key, value in pairs:
        parsed = yaml_load(value)
        path = key.split(".")
        cur: Any = cfg
        for depth, part in enumerate(path):
            arr_m = _DOTLIST_ARR_RE.match(part)
            last = depth == len(path) - 1
            if arr_m:
                name, idx = arr_m.group(1), int(arr_m.group(2))
                seq = cur[name] if name in cur else None
                if seq is None or not isinstance(seq, list):
                    raise AttributeError(f"{key}: '{name}' is not a list in config")
                if idx > len(seq):
                    raise IndexError(f"{key}: index {idx} out of range")
                if idx == len(seq):
                    # appending one-past-the-end is allowed so dotlists can
                    # extend default-empty lists (evaluation.metrics[0]=...)
                    seq.append(_wrap({}) if not last else None)
                if last:
                    seq[idx] = _wrap(parsed)
                else:
                    cur = seq[idx]
            else:
                if last:
                    if strict and isinstance(cur, ConfigNode) and part not in cur \
                            and cur._omega_frozen:
                        raise AttributeError(f"Key '{key}' not found in config")
                    was_frozen = cur._omega_frozen
                    object.__setattr__(cur, "_omega_frozen", False)
                    try:
                        cur[part] = parsed
                    finally:
                        object.__setattr__(cur, "_omega_frozen", was_frozen)
                else:
                    if part not in cur:
                        was_frozen = cur._omega_frozen
                        if strict and was_frozen:
                            raise AttributeError(f"Key '{key}' not found in config")
                        object.__setattr__(cur, "_omega_frozen", False)
                        try:
                            cur[part] = {}
                        finally:
                            object.__setattr__(cur, "_omega_frozen",
                                               was_frozen)
                    cur = cur[part]
    _reroot(cfg, None)
    return cfg


def set_struct(cfg: ConfigNode, value: bool):
    object.__setattr__(cfg, "_omega_frozen", value)
    for k in dict.keys(cfg):
        v = dict.__getitem__(cfg, k)
        if isinstance(v, ConfigNode):
            set_struct(v, value)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, ConfigNode):
                    set_struct(item, value)


def to_container(cfg: Any, resolve: bool = False, _root: Any = None) -> Any:
    if isinstance(cfg, ConfigNode):
        root = cfg._omega_root or cfg
        if resolve:
            return {k: to_container(cfg[k], True, root) for k in dict.keys(cfg)}
        return {k: to_container(dict.__getitem__(cfg, k), False, root)
                for k in dict.keys(cfg)}
    if isinstance(cfg, list):
        return [to_container(v, resolve, _root) for v in cfg]
    # interpolations nested inside lists don't pass through
    # ConfigNode.__getitem__, so resolve them here
    if resolve and isinstance(cfg, str) and "${" in cfg and _root is not None:
        return _resolve_str(cfg, _root)
    return cfg


def resolve_all(cfg: ConfigNode) -> ConfigNode:
    """Eagerly resolve every interpolation (reference resolves before worker
    spawn, configuration.py:349-351)."""
    resolved = to_container(cfg, resolve=True)
    node = ConfigNode(resolved)
    _reroot(node, None)
    return node


def to_yaml(cfg: Any) -> str:
    return yaml.safe_dump(to_container(cfg, resolve=False), default_flow_style=False,
                          sort_keys=False)


# dict-node convenience monkey-alike API
def is_frozen(cfg: ConfigNode) -> bool:
    return bool(getattr(cfg, "_omega_frozen", False))


class open_dict:
    """Context manager: temporarily defrost a (sub)config for edits."""

    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg
        self._states: List = []

    def __enter__(self):
        self._collect(self.cfg)
        return self.cfg

    def _collect(self, node):
        if isinstance(node, ConfigNode):
            self._states.append((node, node._omega_frozen))
            object.__setattr__(node, "_omega_frozen", False)
            for k in dict.keys(node):
                self._collect(dict.__getitem__(node, k))
        elif isinstance(node, list):
            for item in node:
                self._collect(item)

    def __exit__(self, *args):
        for node, state in self._states:
            object.__setattr__(node, "_omega_frozen", state)
        return False
