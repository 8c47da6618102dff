"""Early-stopping callback.

Port of ``mmf_tpu/trainers/callbacks/early_stopping.py``.
"""

from __future__ import annotations

from mmf_tpu_torch.trainers.callbacks.base import Callback
from mmf_tpu_torch.utils.early_stopping import EarlyStopping


class EarlyStoppingCallback(Callback):
    def __init__(self, config, trainer):
        super().__init__(config, trainer)
        early_stop_criteria = self.training_config["early_stop"]["criteria"]
        early_stop_minimize = self.training_config["early_stop"]["minimize"]
        early_stop_enabled = self.training_config["early_stop"]["enabled"]
        early_stop_patience = self.training_config["early_stop"]["patience"]

        self.early_stopping = EarlyStopping(
            getattr(trainer, "model", None),
            getattr(trainer, "checkpoint_callback", None)
            and trainer.checkpoint_callback.checkpoint,
            early_stop_criteria,
            patience=early_stop_patience,
            minimize=early_stop_minimize,
            should_stop=early_stop_enabled,
        )

    def on_validation_end(self, **kwargs):
        return self.early_stopping(
            self.trainer.num_updates,
            self.trainer.current_iteration,
            kwargs["meter"],
        )
