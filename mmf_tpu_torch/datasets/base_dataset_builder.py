"""BaseDatasetBuilder.

Port of ``mmf_tpu/datasets/base_dataset_builder.py``. Lifecycle:
``build(config, dataset_type)`` prepares the data (main process only),
``load(config, dataset_type)`` returns each split's dataset, and the
``*_dataloader`` methods wrap a split in the loader.
"""

from __future__ import annotations

from typing import Optional

from mmf_tpu_torch.utils.distributed import is_main, synchronize


class BaseDatasetBuilder:
    def __init__(self, dataset_name: Optional[str] = None, *args, **kwargs):
        if dataset_name is None:
            dataset_name = "base"
        self._dataset_name = dataset_name
        self.config = None
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None

    @property
    def dataset_name(self):
        return self._dataset_name

    @dataset_name.setter
    def dataset_name(self, dataset_name):
        self._dataset_name = dataset_name

    @classmethod
    def config_path(cls) -> Optional[str]:
        return None

    # -- lifecycle -------------------------------------------------------
    def prepare_data(self, config, *args, **kwargs):
        self.config = config
        if is_main():
            self.build_dataset(config)
        synchronize()

    def setup(self, config=None, stage=None):
        if config is None:
            config = self.config
        self.config = config
        self.train_dataset = self.load_dataset(config, "train")
        self.val_dataset = self.load_dataset(config, "val")
        self.test_dataset = self.load_dataset(config, "test")

    def build_dataset(self, config, dataset_type="train", *args, **kwargs):
        """Prepare the data (main rank only). Override ``build``."""
        self.build(config, dataset_type, *args, **kwargs)

    def load_dataset(self, config, dataset_type="train", *args, **kwargs):
        dataset = self.load(config, dataset_type, *args, **kwargs)
        if dataset is not None and hasattr(dataset, "init_processors"):
            dataset.init_processors()
        return dataset

    def build(self, config, dataset_type="train", *args, **kwargs):
        raise NotImplementedError(
            "This dataset builder doesn't implement a build method"
        )

    def load(self, config, dataset_type="train", *args, **kwargs):
        raise NotImplementedError(
            "This dataset builder doesn't implement a load method"
        )

    # -- dataloaders ------------------------------------------------------
    def _build_dataloader(self, dataset, dataset_type: str):
        from mmf_tpu_torch.config.configuration import get_global_config
        from mmf_tpu_torch.datasets.loader import build_dataloader_and_sampler

        training_config = get_global_config("training")
        loader, _ = build_dataloader_and_sampler(
            dataset, training_config, dataset_type
        )
        return loader

    def train_dataloader(self):
        return self._build_dataloader(self.train_dataset, "train")

    def val_dataloader(self):
        return self._build_dataloader(self.val_dataset, "val")

    def test_dataloader(self):
        return self._build_dataloader(self.test_dataset, "test")

    def teardown(self, *args, **kwargs) -> None:
        pass
