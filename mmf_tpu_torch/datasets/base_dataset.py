"""BaseDataset.

Port of ``mmf_tpu/datasets/base_dataset.py``: a map-style dataset
producing ``Sample``s of fixed-shape arrays. ``init_processors``
instantiates the configured processors onto the dataset and registers
``{dataset}_{processor}`` in the registry for other layers (models read
answer processors from there).
"""

from __future__ import annotations

from typing import Any, Dict

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.common.sample import SampleList


class BaseDataset:
    def __init__(self, dataset_name: str, config: Dict[str, Any] = None,
                 dataset_type: str = "train"):
        self.config = config or {}
        self._dataset_name = dataset_name
        self._dataset_type = dataset_type
        self._global_config = registry.get("config", no_warning=True)

    def load_item(self, idx: int):
        raise NotImplementedError

    def __getitem__(self, idx: int):
        return self.load_item(idx)

    def init_processors(self):
        if "processors" not in self.config:
            return
        from mmf_tpu_torch.datasets.processors.processors import Processor

        extra_params = {"data_dir": self.config.get("data_dir", None)}
        reg_key = f"{self._dataset_name}_{{}}"
        for processor_key, processor_params in self.config["processors"].items():
            if processor_params is None:
                continue
            full_key = reg_key.format(processor_key)
            processor_instance = registry.get(full_key, no_warning=True)
            if processor_instance is None:
                processor_instance = Processor(processor_params, **extra_params)
                registry.register(full_key, processor_instance)
            setattr(self, processor_key, processor_instance)

    def prepare_batch(self, batch: SampleList) -> SampleList:
        """Stamp identity; the trainer moves the batch to the card."""
        if isinstance(batch, SampleList):
            batch.dataset_name = self._dataset_name
            batch.dataset_type = self._dataset_type
        return batch

    @property
    def dataset_type(self):
        return self._dataset_type

    @property
    def name(self):
        return self._dataset_name

    @property
    def dataset_name(self):
        return self._dataset_name

    @dataset_name.setter
    def dataset_name(self, name):
        self._dataset_name = name

    @dataset_type.setter
    def dataset_type(self, dataset_type):
        self._dataset_type = dataset_type

    def format_for_prediction(self, report):
        return []

    def verbose_dump(self, *args, **kwargs):
        return
