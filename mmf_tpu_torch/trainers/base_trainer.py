"""Abstract trainer with the canonical ``load()`` sequence.

Port of ``mmf_tpu/trainers/base_trainer.py`` (reference
mmf/trainers/base_trainer.py:11-101).
"""

from __future__ import annotations

import torch

from mmf_tpu_torch.common.registry import registry


@registry.register_trainer("base")
class BaseTrainer:
    def __init__(self, config):
        self.config = config
        self.training_config = self.config["training"]

    def load(self):
        self.run_type = self.config.get("run_type", "train")
        self.configure_device()
        self.configure_seed()
        if self.training_config.get("detect_anomaly", False):
            torch.autograd.set_detect_anomaly(True)

        self.load_datasets()
        self.load_model()
        self.load_optimizer()
        self.load_metrics()
        self.configure_callbacks()

    def configure_device(self):
        raise NotImplementedError

    def configure_seed(self):
        from mmf_tpu_torch.utils.env import set_seed

        seed = set_seed(self.training_config.get("seed", -1))
        registry.register("seed", seed)
        self.seed = seed

    def configure_callbacks(self):
        raise NotImplementedError

    def load_datasets(self):
        raise NotImplementedError

    def load_model(self):
        raise NotImplementedError

    def load_optimizer(self):
        raise NotImplementedError

    def load_metrics(self):
        raise NotImplementedError

    def train(self):
        raise NotImplementedError

    def inference(self):
        raise NotImplementedError
