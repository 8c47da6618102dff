"""Early stopping.

Port of ``mmf_tpu/utils/early_stopping.py``: monitors a criterion (a
``val/...`` metric or total_loss), tracks the best value and update,
asks the ``Checkpoint`` to keep the best, and signals a stop after
``patience`` updates without improvement. One process decides (the
port runs at world size 1, so there is no decision to broadcast).
"""

from __future__ import annotations

import numpy as np



class EarlyStopping:
    def __init__(
        self,
        model,
        checkpoint_instance,
        monitored_metric: str = "total_loss",
        patience: int = 1000,
        minimize: bool = False,
        should_stop: bool = True,
    ):
        self.minimize = minimize
        self.patience = patience
        self.model = model
        self.checkpoint = checkpoint_instance
        self.monitored_metric = monitored_metric

        if "val" not in self.monitored_metric:
            self.monitored_metric = f"val/{self.monitored_metric}"

        self.best_monitored_value = -np.inf if not minimize else np.inf
        self.best_monitored_iteration = 0
        self.best_monitored_update = 0
        self.should_stop = should_stop
        self.activated = False
        self.metric = self.monitored_metric

    _ACT_NONE, _ACT_SAVE, _ACT_SAVE_BEST, _ACT_STOP = 0, 1, 2, 3

    def __call__(self, update, iteration, meter) -> bool:
        """Returns True when training should stop."""
        action = self._decide(update, iteration, meter)

        if action == self._ACT_SAVE_BEST:
            if self.checkpoint is not None:
                self.checkpoint.save(update, iteration, update_best=True)
            return False
        if action == self._ACT_SAVE:
            if self.checkpoint is not None:
                self.checkpoint.save(update, iteration, update_best=False)
            return False
        if action == self._ACT_STOP:
            self.activated = True
            if self.checkpoint is not None:
                self.checkpoint.restore()
                self.checkpoint.finalize()
            return True
        return False

    def _decide(self, update, iteration, meter) -> int:
        """The action for this validation's meter."""
        value = meter.meters.get(self.monitored_metric, None)
        if value is None:
            raise ValueError(
                f"Metric used for early stopping ({self.monitored_metric}) "
                "is not present in meter."
            )
        value = value.global_avg
        if np.isnan(value):
            return self._ACT_NONE

        improved = (
            value < self.best_monitored_value
            if self.minimize
            else value > self.best_monitored_value
        )
        if improved:
            self.best_monitored_value = value
            self.best_monitored_iteration = iteration
            self.best_monitored_update = update
            return self._ACT_SAVE_BEST
        if self.best_monitored_update + self.patience < update:
            self.activated = True
            if self.should_stop:
                return self._ACT_STOP
            return self._ACT_NONE
        return self._ACT_SAVE

    def is_activated(self) -> bool:
        return self.activated

    def init_from_checkpoint(self, ckpt_info: dict):
        if "best_iteration" in ckpt_info:
            self.best_monitored_iteration = ckpt_info["best_iteration"]
        if "best_update" in ckpt_info:
            self.best_monitored_update = ckpt_info["best_update"]
        if "best_metric_value" in ckpt_info:
            self.best_monitored_value = ckpt_info["best_metric_value"]

    def get_info(self) -> dict:
        return {
            "best_update": self.best_monitored_update,
            "best_iteration": self.best_monitored_iteration,
            f"best_{self.metric}": f"{self.best_monitored_value:.6f}",
        }
