"""Checkpoint callback: resume at init, saves every
``checkpoint_interval`` updates, the best restored at the end.

Port of ``mmf_tpu/trainers/callbacks/checkpoint.py`` over the port's
``utils/checkpoint.py``.
"""

from __future__ import annotations

import logging

from mmf_tpu_torch.trainers.callbacks.base import Callback
from mmf_tpu_torch.utils.checkpoint import Checkpoint

logger = logging.getLogger(__name__)


class CheckpointCallback(Callback):
    def __init__(self, config, trainer):
        super().__init__(config, trainer)
        self._checkpoint = Checkpoint(trainer)
        self.checkpoint_interval = self.config["training"]["checkpoint_interval"]

    @property
    def checkpoint(self) -> Checkpoint:
        return self._checkpoint

    def on_init_start(self, **kwargs):
        self._checkpoint.load_state_dict()

    def on_update_end(self, **kwargs):
        if self.trainer.num_updates % self.checkpoint_interval == 0:
            logger.info("Checkpoint time. Saving a checkpoint.")
            self._checkpoint.save(
                self.trainer.num_updates,
                self.trainer.current_iteration,
                update_best=False,
            )

    def on_train_end(self, **kwargs):
        if self.trainer.early_stop_callback is not None and \
                self.trainer.early_stop_callback.early_stopping.best_monitored_update > 0:
            self._checkpoint.restore()
        self._checkpoint.finalize()
