"""Optimizer parameter grouping: weight-decay masks and lr multipliers.

Port of ``mmf_tpu/utils/modeling.py``. The JAX package expresses both
policies as optax transforms over the param pytree (a bool mask for
``optax.adamw`` and ``scale_updates_by_prefix``); here they become torch
parameter groups: each group carries its ``weight_decay`` (0 where the
mask says no decay) and an lr already multiplied by its scale. Parameter
names are the port's dotted names, which mirror the flax paths
(``bert.encoder.layer_0.attention.query.weight``); prefixes given with
``/`` as in the JAX package match the same names.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from torch import nn


def _owner_and_leaf(model: nn.Module):
    """(dotted name, owning module, leaf name, parameter) of every
    parameter, in ``named_parameters`` order."""
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        yield name, modules[owner], leaf, p


def _is_layer_norm(module: nn.Module) -> bool:
    from mmf_tpu_torch.modules.transformer import ResidualLayerNorm

    return isinstance(module, (nn.LayerNorm, ResidualLayerNorm))


def lr_multiplier_labels(model: nn.Module,
                         prefix_scales: Dict[str, float]) -> Dict[str, float]:
    """Scale of every parameter: that of the longest matching name
    prefix ('' matches all; default 1.0)."""
    labels = {}
    for name, _ in model.named_parameters():
        path = name.replace(".", "/")
        best, best_len = 1.0, -1
        for prefix, scale in prefix_scales.items():
            if path.startswith(prefix.replace(".", "/")) and \
                    len(prefix) > best_len:
                best, best_len = float(scale), len(prefix)
        labels[name] = best
    return labels


def get_bert_configured_parameters(model: nn.Module) -> Dict[str, bool]:
    """Weight-decay mask (True = decay) by the JAX package's loose rule:
    no decay where the flax path holds ``bias``, ``layer_norm``,
    ``layernorm`` or ends a LayerNorm ``scale``."""
    mask = {}
    for name, owner, leaf, _ in _owner_and_leaf(model):
        path = name.lower()
        mask[name] = not ("bias" in path or "layer_norm" in path
                          or "layernorm" in path or _is_layer_norm(owner))
    return mask


def bert_no_decay_mask(scopes=None) -> Callable[[nn.Module], Dict[str, bool]]:
    """Callable ``model -> {name: decay}`` (True = apply weight decay),
    the reference's no-decay list ``["bias", "LayerNorm.bias",
    "LayerNorm.weight"]``: every ``bias`` and both LayerNorm parameters
    (flax ``scale``/``bias``).

    scopes: optional top-level module names the exemption applies to;
    parameters outside them decay unconditionally."""
    scope_set = tuple(scopes) if scopes is not None else None

    def mask_fn(model: nn.Module) -> Dict[str, bool]:
        mask = {}
        for name, owner, leaf, _ in _owner_and_leaf(model):
            if scope_set is not None and name.split(".")[0] not in scope_set:
                mask[name] = True
                continue
            leaf = leaf.lower()
            no_decay = (leaf.endswith("bias") or _is_layer_norm(owner)
                        or "layer_norm" in leaf or "layernorm" in leaf)
            mask[name] = not no_decay
        return mask

    return mask_fn


def param_groups(model: nn.Module, lr: float, weight_decay: float,
                 weight_decay_mask: Optional[Dict[str, bool]] = None,
                 lr_scales: Optional[Dict[str, float]] = None) -> List[dict]:
    """Torch parameter groups, one per (decay, lr scale) pair, in the
    order their first parameter appears. Each group has ``params``,
    ``names``, ``lr`` (``lr`` times its scale), ``lr_scale`` and
    ``weight_decay`` (0 where the mask says no decay)."""
    groups: Dict[tuple, dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        decay = True if weight_decay_mask is None else weight_decay_mask[name]
        scale = 1.0 if lr_scales is None else lr_scales[name]
        key = (decay, scale)
        if key not in groups:
            groups[key] = {"params": [], "names": [], "lr": lr * scale,
                           "lr_scale": scale,
                           "weight_decay": weight_decay if decay else 0.0}
        groups[key]["params"].append(p)
        groups[key]["names"].append(name)
    return list(groups.values())


def get_optimizer_parameters_for_bert(model: nn.Module, config):
    """``(weight_decay_mask, lr prefix scales or None)`` for a BERT
    model: the loose no-decay rule, and when the model config sets
    ``finetune_lr_multiplier`` != 1, that scale on everything but the
    classifier and heads."""
    model_config = config.get("model_config", {}).get(
        config.get("model", ""), {}
    ) or {}
    finetune_mult = model_config.get("finetune_lr_multiplier", 1)
    mask = get_bert_configured_parameters(model)
    scales = None
    if finetune_mult != 1:
        scales = {"": float(finetune_mult), "classifier": 1.0, "heads": 1.0}
    return mask, scales
