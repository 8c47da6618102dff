"""Configuration: YAML loading and the build pipeline.

Port of ``mmf_tpu/config/configuration.py``: YAML loading with recursive
``includes:`` merge, then the precedence chain defaults -> the model's
config -> the datasets' configs -> the user config (``config=``) ->
``config_override`` -> the command line's dotlist, the resolvers
(``device_count``, ``resolve_cache_dir``, ``resolve_dir``), eager
resolution and freezing. (The zoo lookup is left out: the port
downloads nothing.)

The port reads the JAX package's ``configs/`` tree and its
``config/defaults.yaml`` as data: relative paths resolve against
``mmf_tpu/`` (so ``"configs/models/visual_bert/defaults.yaml"`` loads
unchanged), then against the repo root. ``device_count`` counts the CUDA
devices (1 without a card).
"""

from __future__ import annotations

import collections.abc
import json
import logging
import os
import warnings
from ast import literal_eval
from typing import List, Optional

from mmf_tpu_torch.config import omega
from mmf_tpu_torch.config.omega import ConfigNode

logger = logging.getLogger(__name__)


def get_repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def get_config_root() -> str:
    """Directory whose ``configs/`` tree the port reads: the JAX
    package's, located on disk next to this package (never imported)."""
    return os.path.join(get_repo_root(), "mmf_tpu")


def _resolve(path: str, base_dir: str = None) -> str:
    if os.path.isabs(path) or os.path.exists(path):
        return path
    roots = ([base_dir] if base_dir else []) + [
        get_config_root(), get_repo_root(),
    ]
    for root in roots:
        candidate = os.path.join(root, path)
        if os.path.exists(candidate):
            return candidate
    return path


# ---------------------------------------------------------------------------
# resolvers (reference configuration.py:493-499)
# ---------------------------------------------------------------------------
def resolve_cache_dir(env_variable="MMF_CACHE_DIR", default="mmf"):
    """``$MMF_CACHE_DIR``, else ``~/.cache/<default>`` (not created here:
    whatever writes there creates it)."""
    cache_path = os.path.join(os.path.expanduser("~"), ".cache", default)
    return os.environ.get(env_variable, cache_path)


def resolve_dir(env_variable, default="data"):
    default_dir = os.path.join(resolve_cache_dir(), default)
    return os.environ.get(env_variable, default_dir)


def _device_count():
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _register_resolvers():
    omega.register_resolver("device_count", lambda *a: _device_count(),
                            replace=True)
    omega.register_resolver("resolve_cache_dir", resolve_cache_dir,
                            replace=True)
    omega.register_resolver("resolve_dir", resolve_dir, replace=True)


# ---------------------------------------------------------------------------
# YAML loading with includes (reference configuration.py:21-82)
# ---------------------------------------------------------------------------
def load_yaml(f: str) -> ConfigNode:
    abs_f = _resolve(f)
    mapping = omega.load(abs_f)
    if mapping is None:
        mapping = omega.create()

    includes = dict.get(mapping, "includes", [])
    if not isinstance(includes, collections.abc.Sequence):
        raise AttributeError(
            f"Includes must be a list, {type(includes)} provided"
        )

    include_mapping = omega.create()
    for include in includes:
        # relative to the including file first, then the config roots
        current = load_yaml(_resolve(include, os.path.dirname(abs_f)))
        include_mapping = omega.merge(include_mapping, current)

    if "includes" in mapping:
        dict.pop(mapping, "includes")

    return omega.merge(include_mapping, mapping)


def get_default_config_path() -> str:
    return os.path.join(get_config_root(), "config", "defaults.yaml")


# ---------------------------------------------------------------------------
# global accessors (reference configuration.py:135-162)
# ---------------------------------------------------------------------------
def get_global_config(key: Optional[str] = None):
    from mmf_tpu_torch.common.registry import registry

    config = registry.get("config")
    if config is None:
        configuration = Configuration()
        config = configuration.get_config()
        registry.register("config", config)
    if key:
        for k in key.split("."):
            config = config[k]
    return config


def get_mmf_env(key: Optional[str] = None):
    config = get_global_config()
    if key:
        return config["env"].get(key, None)
    return config["env"]


def _merge_with_dotlist(config, opts, dont_merge_keys=None):
    return omega.merge_with_dotlist(config, opts, strict=False)


# ---------------------------------------------------------------------------
# Configuration class (reference configuration.py:313-…)
# ---------------------------------------------------------------------------
class Configuration:
    def __init__(self, args=None, default_only: bool = False):
        self.config = {}
        self.args = args
        _register_resolvers()

        self._default_config = self._build_default_config()

        if default_only:
            other_configs = {}
        else:
            other_configs = self._build_other_configs()

        self.config = omega.merge(self._default_config, other_configs)

        self.config = _merge_with_dotlist(self.config, self._get_opts())
        self._update_specific(self.config)
        self.upgrade(self.config)
        # resolve eagerly so the frozen config carries concrete values
        self.config = omega.resolve_all(self.config)
        omega.set_struct(self.config, True)

    # --------------------------------------------------------------
    def _get_opts(self) -> List[str]:
        if self.args is None:
            return []
        if isinstance(self.args, list):
            return self.args
        opts = getattr(self.args, "opts", None) or []
        return list(opts)

    def _build_default_config(self) -> ConfigNode:
        self.default_config_path = get_default_config_path()
        return load_yaml(self.default_config_path)

    def _build_other_configs(self) -> ConfigNode:
        opts_config = self._build_opt_list(self._get_opts())
        user_config = self._build_user_config(opts_config)

        self._opts_config = opts_config
        self.user_config = user_config

        args_overrides = self._build_demjson_config(
            getattr(self.args, "config_override", None) if self.args else None
        )

        other_configs = omega.merge(user_config, args_overrides)

        # model=/datasets= usually arrive as dotlist opts (the primary CLI
        # form), so include them when resolving which default configs to pull
        lookup = omega.merge(other_configs, opts_config)
        # user plugin dir must be imported BEFORE model/dataset config
        # resolution so plugin-registered classes are found (reference
        # configuration.py:393-410 precedence: env default -> user config
        # -> opts)
        self._import_user_dir(lookup)
        model_config = self._build_model_config(lookup)
        dataset_config = self._build_dataset_config(lookup)
        args_config = omega.merge(model_config, dataset_config, other_configs)
        return args_config

    def _import_user_dir(self, lookup) -> None:
        """Import the env.user_dir plugin directory (reference
        configuration.py:393-410): default env var, overridden by the
        user config yaml, overridden by dotlist opts."""
        user_dir = os.environ.get("MMF_USER_DIR", "") or None
        cfg_user_dir = (
            self._default_config.get("env", {}).get("user_dir", None)
        )
        if cfg_user_dir and "${" not in str(cfg_user_dir):
            user_dir = cfg_user_dir
        lookup_user_dir = (lookup.get("env", {}) or {}).get("user_dir", None)
        if lookup_user_dir:
            user_dir = lookup_user_dir
        if user_dir:
            from mmf_tpu_torch.utils.env import import_user_module

            import_user_module(user_dir)

    def _build_opt_list(self, opts: List[str]) -> ConfigNode:
        # Turn dotlist into a nested config for peeking at config/model/datasets
        node = omega.create()
        try:
            omega.merge_with_dotlist(node, opts, strict=False)
        except Exception:
            pass
        return node

    def _build_user_config(self, opts_config) -> ConfigNode:
        user_config = omega.create()
        self.config_path = opts_config.get("config", None)
        if self.config_path is not None:
            user_config = load_yaml(self.config_path)
        return user_config

    def _build_demjson_config(self, demjson_string) -> ConfigNode:
        if demjson_string is None:
            return omega.create()
        try:
            demjson_dict = json.loads(demjson_string)
        except json.JSONDecodeError:
            demjson_dict = literal_eval(demjson_string)
        return omega.create(demjson_dict)

    def _build_model_config(self, config) -> ConfigNode:
        model = config.get("model", None)
        if model is None:
            return omega.create()

        from mmf_tpu_torch.common.registry import registry

        model_cls = registry.get_model_class(model)
        if model_cls is None:
            warning = f"No model named '{model}' has been registered"
            warnings.warn(warning)
            return omega.create()

        default_model_config_path = model_cls.config_path()
        if default_model_config_path is None:
            warnings.warn(f"Model {model} has no default config")
            return omega.create()
        return load_yaml(default_model_config_path)

    def _build_dataset_config(self, config) -> ConfigNode:
        dataset = config.get("dataset", None)
        datasets = config.get("datasets", None)
        if dataset is None and datasets is None:
            return omega.create()
        if dataset is not None and datasets is None:
            datasets = dataset

        if isinstance(datasets, str):
            datasets = list(map(lambda x: x.strip(), datasets.split(",")))

        dataset_config = omega.create()
        from mmf_tpu_torch.common.registry import registry

        for d in datasets:
            builder_cls = registry.get_builder_class(d)
            if builder_cls is None:
                warning = f"No dataset named '{d}' has been registered"
                warnings.warn(warning)
                continue
            default_dataset_config_path = builder_cls.config_path()
            if default_dataset_config_path is None:
                continue
            dataset_config = omega.merge(
                dataset_config, load_yaml(default_dataset_config_path)
            )
        return dataset_config

    # --------------------------------------------------------------
    def get_config(self) -> ConfigNode:
        return self.config

    def freeze(self):
        omega.set_struct(self.config, True)

    def defrost(self):
        omega.set_struct(self.config, False)

    def _update_specific(self, config):
        # `dataset=` (singular, the documented CLI form) populates
        # `datasets`, the canonical key the trainer reads
        # (reference configuration.py:560-575)
        dataset = config.get("dataset", None)
        if dataset is not None and not config.get("datasets", None):
            warnings.warn(
                "'dataset' is deprecated in favor of 'datasets'; "
                "setting datasets from it"
            )
            config["datasets"] = dataset

        # batch size vs batch_size_per_device mutual exclusion warning
        return config

    def upgrade(self, config):
        mapping = {
            "training.resume_file": "checkpoint.resume_file",
            "training.resume": "checkpoint.resume",
            "training.resume_best": "checkpoint.resume_best",
            "training.load_pretrained": "checkpoint.resume_pretrained",
            "training.pretrained_state_mapping": "checkpoint.pretrained_state_mapping",
            "training.run_type": "run_type",
        }
        for old, new in mapping.items():
            value = self._get_dotted(config, old)
            if value is not None:
                self._set_dotted(config, new, value)

    @staticmethod
    def _get_dotted(config, key):
        cur = config
        for part in key.split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                return None
        return cur

    @staticmethod
    def _set_dotted(config, key, value):
        parts = key.split(".")
        cur = config
        for part in parts[:-1]:
            if part not in cur:
                cur[part] = {}
            cur = cur[part]
        cur[parts[-1]] = value

    def pretty_print(self):
        if not self.config.training.log_detailed_config:
            return
        logger.info("=====  Training Parameters    =====")
        logger.info(omega.to_yaml(self.config.training))
        logger.info("======  Dataset Attributes  ======")
        for dataset in self.config.datasets:
            if dataset in self.config.dataset_config:
                logger.info(f"======== {dataset} =======")
                logger.info(omega.to_yaml(self.config.dataset_config[dataset]))
        logger.info("======  Optimizer Attributes  ======")
        logger.info(omega.to_yaml(self.config.optimizer))
        logger.info(f"======  Model ({self.config.model}) Attributes  ======")
        logger.info(omega.to_yaml(self.config.model_config[self.config.model]))
