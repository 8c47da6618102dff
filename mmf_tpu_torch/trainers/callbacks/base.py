"""Callback base with the reference's hook points.

Port of ``mmf_tpu/trainers/callbacks/base.py``.
"""

from __future__ import annotations


class Callback:
    def __init__(self, config, trainer):
        self.config = config
        self.trainer = trainer
        self.training_config = self.config["training"]

    def teardown(self, **kwargs):
        pass

    def on_init_start(self, **kwargs):
        pass

    def on_init_end(self, **kwargs):
        pass

    def on_train_start(self, **kwargs):
        pass

    def on_train_end(self, **kwargs):
        pass

    def on_batch_start(self, **kwargs):
        pass

    def on_batch_end(self, **kwargs):
        pass

    def on_update_start(self, **kwargs):
        pass

    def on_update_end(self, **kwargs):
        pass

    def on_validation_start(self, **kwargs):
        pass

    def on_validation_end(self, **kwargs):
        pass

    def on_validation_batch_start(self, **kwargs):
        pass

    def on_validation_batch_end(self, **kwargs):
        pass

    def on_test_start(self, **kwargs):
        pass

    def on_test_end(self, **kwargs):
        pass

    def on_test_batch_start(self, **kwargs):
        pass

    def on_test_batch_end(self, **kwargs):
        pass

    def on_prediction_start(self, **kwargs):
        pass

    def on_prediction_end(self, **kwargs):
        pass
