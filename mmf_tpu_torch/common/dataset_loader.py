"""Deprecated ``DatasetLoader`` shim.

Port of ``mmf_tpu/common/dataset_loader.py``: kept so that code importing
``DatasetLoader`` keeps working; it wraps ``MultiDataModule``, which is
the supported API.
"""

from __future__ import annotations

import warnings


class DatasetLoader:
    def __init__(self, config):
        warnings.warn(
            "DatasetLoader is deprecated; use "
            "mmf_tpu_torch.datasets.multi_datamodule.MultiDataModule",
            DeprecationWarning,
        )
        self.config = config
        self._datamodule = None

    def load_datasets(self):
        from mmf_tpu_torch.datasets.multi_datamodule import MultiDataModule

        self._datamodule = MultiDataModule(self.config)

    def train_dataloader(self):
        return self._datamodule.train_dataloader()

    def val_dataloader(self):
        return self._datamodule.val_dataloader()

    def test_dataloader(self):
        return self._datamodule.test_dataloader()

    def get_test_reporter(self, dataset_type):
        return self._datamodule.get_test_reporter(dataset_type)

    def prepare_batch(self, batch, *args, **kwargs):
        return self._datamodule.prepare_batch(batch)
