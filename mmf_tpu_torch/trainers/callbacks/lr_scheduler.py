"""LR scheduler callback.

Port of ``mmf_tpu/trainers/callbacks/lr_scheduler.py``. The train step
steps the ``LambdaLR`` after each update, so this callback only tracks
the current lr for the logs: the base lr times the trainer's own
schedule (built once in ``load_optimizer``) at the update count.
"""

from __future__ import annotations

from mmf_tpu_torch.trainers.callbacks.base import Callback


class LRSchedulerCallback(Callback):
    def __init__(self, config, trainer):
        super().__init__(config, trainer)
        base_lr = (
            (self.config.get("optimizer", {}) or {})
            .get("params", {})
            .get("lr", 0.0)
        )
        try:
            # YAML 1.1 parses a bare '5e-5' as a string
            self._base_lr = float(base_lr)
        except (TypeError, ValueError):
            self._base_lr = 0.0

    def on_update_end(self, **kwargs):
        schedule_fn = getattr(self.trainer, "_schedule_fn", None)
        if schedule_fn is not None:
            mult = float(schedule_fn(self.trainer.num_updates))
            self.trainer.current_lr = self._base_lr * mult
