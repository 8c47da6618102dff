"""Learning-rate schedules as multipliers of the base lr.

Port of ``mmf_tpu/modules/schedulers.py``. Each registered scheduler is a
factory ``(config, scheduler_params) -> schedule``, where ``schedule(step)``
is the multiplier of every group's lr at optimizer update ``step``
(counted from 0), as ``optax.scale_by_schedule`` applies it after the
optimizer. ``build_lr_scheduler`` wraps a schedule in a ``LambdaLR``, so
update ``n`` runs at ``lr * schedule(n)`` when the train step calls
``lr_scheduler.step()`` after each ``optimizer.step()``.
"""

from __future__ import annotations

import math

import torch

from mmf_tpu_torch.common.registry import registry


def _warmup_or_decay(step, warmup_iterations, warmup_factor, lr_steps,
                     lr_ratio):
    if warmup_iterations > 0 and step < warmup_iterations:
        alpha = step / max(warmup_iterations, 1)
        return warmup_factor * (1.0 - alpha) + alpha
    return lr_ratio ** sum(step >= s for s in lr_steps)


@registry.register_scheduler("pythia")
def pythia_scheduler(config, scheduler_params=None):
    """Warmup by a constant factor, then step decay at ``lr_steps``, all
    from ``training``."""
    training = config["training"]
    use_warmup = training.get("use_warmup", False)
    warmup = training.get("warmup_iterations", 1000) if use_warmup else 0
    factor = training.get("warmup_factor", 0.2)
    lr_steps = list(training.get("lr_steps", []))
    ratio = training.get("lr_ratio", 0.1)
    return lambda step: _warmup_or_decay(step, warmup, factor, lr_steps,
                                         ratio)


@registry.register_scheduler("warmup_linear")
def warmup_linear_scheduler(config, scheduler_params=None):
    """Linear warmup, then linear decay to zero at num_training_steps."""
    p = scheduler_params or {}
    num_warmup = p.get("num_warmup_steps", 2000)
    num_training = p.get("num_training_steps",
                         config["training"]["max_updates"])

    def schedule(step):
        if step < num_warmup:
            return step / max(1.0, num_warmup)
        return max(0.0, (num_training - step)
                   / max(1.0, num_training - num_warmup))

    return schedule


@registry.register_scheduler("warmup_cosine")
def warmup_cosine_scheduler(config, scheduler_params=None):
    """Linear warmup, then cosine decay over num_training_steps."""
    p = scheduler_params or {}
    num_warmup = p.get("num_warmup_steps", 2000)
    num_training = p.get("num_training_steps",
                         config["training"]["max_updates"])
    num_cycles = p.get("num_cycles", 0.5)

    def schedule(step):
        if step < num_warmup:
            return step / max(1.0, num_warmup)
        progress = (step - num_warmup) / max(1.0, num_training - num_warmup)
        return max(0.0, 0.5 * (1.0 + math.cos(
            math.pi * num_cycles * 2.0 * progress)))

    return schedule


@registry.register_scheduler("multi_step")
def multi_step_scheduler(config, scheduler_params=None):
    """Step decay at ``lr_steps`` with optional warmup, from the
    scheduler's own params."""
    p = scheduler_params or {}
    use_warmup = p.get("use_warmup", False)
    warmup = p.get("warmup_iterations", 0) if use_warmup else 0
    factor = p.get("warmup_factor", 0.2)
    lr_steps = list(p.get("lr_steps", []))
    ratio = p.get("lr_ratio", 0.1)
    return lambda step: _warmup_or_decay(step, warmup, factor, lr_steps,
                                         ratio)


def build_scheduler(config):
    """The configured schedule, or None when lr scheduling is off."""
    training = config["training"]
    scheduler_config = config.get("scheduler", {}) or {}
    if not training.get("lr_scheduler", False) and not scheduler_config:
        return None
    stype = scheduler_config.get("type", "pythia")
    params = scheduler_config.get("params", {})
    factory = registry.get_scheduler_class(stype)
    if factory is None:
        raise ValueError(f"No scheduler named {stype} registered")
    return factory(config, params)


def build_lr_scheduler(optimizer: torch.optim.Optimizer, schedule):
    """``LambdaLR`` applying ``schedule`` to every group's lr (None: no
    scheduler)."""
    if schedule is None:
        return None
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lr_lambda=schedule)
