"""Optimizer construction: the optax chain of the JAX package, in torch.

Port of ``mmf_tpu/modules/optimizers.py::build_optimizer_transform``,
whose chain is ``clip_by_global_norm -> optimizer (weight-decay mask) ->
scale_by_schedule -> lr multipliers``. Here:

- ``build_optimizer`` returns a ``torch.optim`` optimizer over parameter
  groups (``utils/modeling.py::param_groups``) that carry the weight-decay
  mask and the lr multipliers, with the same translation of
  ``optimizer.params`` (``lr``, ``betas``, ``eps``, ``weight_decay``;
  ``adam_w`` defaults ``weight_decay`` to 0.01 as torch does);
- the schedule is ``modules/schedulers.py::build_lr_scheduler``, a
  ``LambdaLR`` whose multiplier scales every group's lr, and so the
  decoupled weight decay too, as ``scale_by_schedule`` scales the whole
  optax update;
- ``clip_grad_norm`` clips by global norm before the update, with optax's
  formula; ``utils/general.py::clip_gradients_config`` gives the norm.

``adam_w_skip_params_with_zero_grad`` is registered as in JAX: AdamW that
leaves a parameter and its moments untouched in a step where its
gradient is all zero.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from mmf_tpu_torch.common.registry import registry

# torch-name aliases the config may use
_TORCH_OPTIMIZERS = {
    "Adam": torch.optim.Adam, "adam": torch.optim.Adam,
    "AdamW": torch.optim.AdamW, "adam_w": torch.optim.AdamW,
    "adamw": torch.optim.AdamW,
    "SGD": torch.optim.SGD, "sgd": torch.optim.SGD,
    "Adamax": torch.optim.Adamax, "adamax": torch.optim.Adamax,
    "RMSprop": torch.optim.RMSprop, "rmsprop": torch.optim.RMSprop,
    "Adagrad": torch.optim.Adagrad, "adagrad": torch.optim.Adagrad,
}


def _coerce_numeric(v):
    """YAML 1.1 parses '5e-05' (no dot) as a string; coerce such values."""
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return v
    if isinstance(v, (list, tuple)):
        return tuple(_coerce_numeric(x) for x in v)
    return v


@registry.register_optimizer("adam_w_skip_params_with_zero_grad")
class AdamWSkipParamsWithZeroGrad(torch.optim.AdamW):
    """AdamW that skips the whole update, moments and weight decay
    included, for a parameter whose gradient is all zero this step. The
    step count advances for every parameter, as optax's single count
    does. optax.adamw's formulas; the skip is a ``torch.where`` on a flag
    computed on the device, so a step never waits on the host."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            if group["amsgrad"] or group["maximize"]:
                raise NotImplementedError(
                    "adam_w_skip_params_with_zero_grad has no amsgrad or "
                    "maximize form")
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                live = g.ne(0).any()
                mu = torch.where(live, b1 * state["exp_avg"] + (1 - b1) * g,
                                 state["exp_avg"])
                nu = torch.where(live,
                                 b2 * state["exp_avg_sq"] + (1 - b2) * g * g,
                                 state["exp_avg_sq"])
                state["exp_avg"], state["exp_avg_sq"] = mu, nu
                update = (mu / (1 - b1 ** t)) / (
                    (nu / (1 - b2 ** t)).sqrt() + eps) + wd * p
                p.copy_(torch.where(live, p - lr * update, p))
        return loss


def build_optimizer(
    config,
    model: torch.nn.Module,
    lr_multipliers: Optional[Dict[str, float]] = None,
    weight_decay_mask=None,
) -> torch.optim.Optimizer:
    """The configured optimizer over ``model``'s parameters: type from
    ``optimizer.type`` (a torch name or a registered optimizer), params
    from ``optimizer.params``. ``weight_decay_mask``: ``{name: decay}``
    or a callable ``model -> {name: decay}`` (the model's
    ``get_weight_decay_mask``); ``lr_multipliers``: ``{name prefix:
    scale}`` (the model's ``get_lr_multipliers``)."""
    from mmf_tpu_torch.utils.modeling import lr_multiplier_labels, param_groups

    optimizer_config = config["optimizer"]
    if "type" not in optimizer_config:
        raise ValueError(
            "Optimizer attributes must have a 'type' key specifying the "
            "type of optimizer (e.g. 'adam_w')"
        )
    name = optimizer_config["type"]
    params = {k: _coerce_numeric(v)
              for k, v in dict(optimizer_config.get("params", {})).items()}
    opt_cls = registry.get_optimizer_class(name) or _TORCH_OPTIMIZERS.get(name)
    if opt_cls is None:
        raise ValueError(f"No optimizer '{name}' in torch.optim or registry")
    if issubclass(opt_cls, torch.optim.AdamW):
        # torch.optim.AdamW's own default, stated: optax's 1e-4 default
        # would diverge from the reference
        params.setdefault("weight_decay", 0.01)
    if "betas" in params:
        params["betas"] = tuple(params["betas"])
    lr = params.pop("lr", 1e-3)
    weight_decay = params.pop("weight_decay", 0.0)
    if callable(weight_decay_mask):
        weight_decay_mask = weight_decay_mask(model)
    scales = (lr_multiplier_labels(model, lr_multipliers)
              if lr_multipliers else None)
    groups = param_groups(model, lr, weight_decay, weight_decay_mask, scales)
    return opt_cls(groups, lr=lr, weight_decay=weight_decay, **params)


@torch.no_grad()
def clip_grad_norm(parameters: Iterable[torch.Tensor],
                   max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: when the global L2 norm g of the
    gradients exceeds ``max_norm``, scale them by ``max_norm / g``.
    Returns g. No host synchronisation."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor.to(grads[0].dtype))
    return norm
