"""The train and eval steps: the device side of the trainer.

Port of ``mmf_tpu/trainers/core/train_state.py``, with the same contract:

  train_step(state, batch) -> (state', report)

- gradient accumulation over ``update_frequency`` microbatches, each loss
  divided by it, so the update equals the unsplit step's;
- clipping by global norm before the update (``max_grad_norm``; the JAX
  package puts it at the head of its optax chain);
- the report holds ``losses`` (per key, mean over microbatches),
  ``total_loss``, ``nan_flag`` and ``num_updates``, plus the model-output
  fields named in ``report_fields``; losses the model returns itself
  take precedence over the registered ones;
- every parameter gets a gradient, zeros where the loss does not reach
  it, as ``jax.grad`` gives every leaf one (so weight decay and the
  moments still move there, as in optax);
- f32 master parameters, bf16 compute: the model's ``Dense``/``Embed``
  cast per call, and the step never casts the weights;
- dropout masks come from a ``torch.Generator`` seeded by
  ``fold_in(state.seed, state.step)`` (and the microbatch index), the
  counterpart of ``jax.random.fold_in(state.rng, state.step)``.

PyTorch modules hold their parameters, so the step updates the model and
optimizer in place and returns a state whose ``step`` has advanced. The
report's values stay on the device: reading them synchronises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmf_tpu_torch.modules.optimizers import clip_grad_norm
from mmf_tpu_torch.modules.transformer import dropout_generator

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_scheduler: Optional[Any]
    seed: int


def create_train_state(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, seed: int,
                       lr_scheduler=None) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer,
                      lr_scheduler=lr_scheduler, seed=int(seed))


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_device(batch: Dict[str, Any], device: torch.device):
    """numpy arrays and tensors onto ``device``; other leaves as they
    are."""
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return x

    return _tree_map(move, batch)


def _split_microbatches(batch: Dict[str, Any], n: int):
    """[B, ...] -> n batches of [B/n, ...] on every tensor leaf."""
    def split(x):
        if not isinstance(x, torch.Tensor):
            return [x] * n
        b = x.shape[0]
        if b % n != 0:
            raise ValueError(
                f"batch {b} not divisible by update_frequency {n}")
        return x.reshape((n, b // n) + tuple(x.shape[1:])).unbind(0)

    parts = _tree_map(split, batch)

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]

    return [take(parts, i) for i in range(n)]


def make_train_step(
    losses_fn: Callable,
    update_frequency: int = 1,
    max_grad_norm: Optional[float] = None,
    meta: Optional[Dict[str, Any]] = None,
    report_fields: Tuple[str, ...] = (),
) -> Callable:
    """Build the train step.

    losses_fn(batch_with_meta, output) -> {loss_key: tensor}
    report_fields: model-output fields (e.g. "scores") carried into the
    report, concatenated over microbatches.
    """
    meta = meta or {}

    def train_step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        device = next(model.parameters()).device
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        batch = _to_device(batch, device)
        step_seed = fold_in(state.seed, state.step)
        micro = ([batch] if update_frequency == 1
                 else _split_microbatches(batch, update_frequency))
        losses: Dict[str, torch.Tensor] = {}
        reported = []
        for i, mb in enumerate(micro):
            seed = step_seed if update_frequency == 1 else fold_in(
                step_seed, i)
            gen = torch.Generator(device=device).manual_seed(seed)
            batch_in = dict(mb)
            batch_in.update(meta)
            with dropout_generator(gen):
                output = model(batch_in)
            # model-provided losses take precedence over registered ones
            if "losses" in output:
                mb_losses = dict(output["losses"])
            else:
                mb_losses = dict(losses_fn(batch_in, output))
            total = sum(v.mean() for v in mb_losses.values())
            (total / update_frequency).backward()
            for k, v in mb_losses.items():
                mean = v.detach().mean() / update_frequency
                losses[k] = losses[k] + mean if k in losses else mean
            reported.append({k: output[k].detach() for k in report_fields
                             if k in output})

        total_loss = sum(losses.values())
        nan_flag = ~torch.isfinite(total_loss)
        for p in model.parameters():
            # jax.grad gives every leaf a gradient: a parameter the loss
            # does not reach (the pooler under the vqa pooler strategy)
            # still gets its weight decay and moment updates
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        if max_grad_norm:
            clip_grad_norm(model.parameters(), max_grad_norm)
        state.optimizer.step()
        if state.lr_scheduler is not None:
            state.lr_scheduler.step()

        new_state = dataclasses.replace(state, step=state.step + 1)
        report = {
            "losses": losses,
            "total_loss": total_loss,
            "nan_flag": nan_flag,
            "num_updates": new_state.step,
        }
        for k in (reported[0] if reported else {}):
            report[k] = torch.cat([r[k] for r in reported], dim=0)
        return new_state, report

    return train_step


def make_eval_step(losses_fn: Optional[Callable] = None,
                   meta: Optional[Dict[str, Any]] = None) -> Callable:
    """``eval_step(model, batch) -> output``: the model in eval mode
    without gradients, plus ``losses`` when ``losses_fn`` is given and
    the model returned none."""
    meta = meta or {}

    def eval_step(model: torch.nn.Module, batch: Dict[str, Any]):
        device = next(model.parameters()).device
        batch_in = dict(_to_device(batch, device))
        batch_in.update(meta)
        model.eval()
        with torch.no_grad():
            output = dict(model(batch_in))
            if losses_fn is not None and "losses" not in output:
                output["losses"] = dict(losses_fn(batch_in, output))
        return output

    return eval_step
