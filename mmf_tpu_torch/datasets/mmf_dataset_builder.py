"""MMFDatasetBuilder: per-imdb datasets concatenated by split.

Port of ``mmf_tpu/datasets/mmf_dataset_builder.py``. ``load`` builds one
dataset per annotation file of a split and concatenates them. ``build``
is where JAX downloads the zoo's resources; the port downloads nothing,
so it checks that every annotation and feature path the config names is
on disk and raises an error naming the first one that is not.
``split_train`` is not ported yet.
"""

from __future__ import annotations

import os
import warnings

from mmf_tpu_torch.datasets.base_dataset_builder import BaseDatasetBuilder
from mmf_tpu_torch.datasets.concat_dataset import MMFConcatDataset
from mmf_tpu_torch.utils.general import get_absolute_path


class MMFDatasetBuilder(BaseDatasetBuilder):
    def __init__(self, dataset_name=None, dataset_class=None,
                 zoo_variation="defaults", *args, **kwargs):
        super().__init__(dataset_name)
        self.dataset_class = dataset_class

    def set_dataset_class(self, dataset_cls):
        self.dataset_class = dataset_cls

    def build(self, config, dataset_type="train", *args, **kwargs):
        """Check that the data is on disk (reference
        mmf_dataset_builder.py:63-123 downloads it)."""
        if config.get("split_train", False):
            raise NotImplementedError(
                f"{self.dataset_name}: split_train is not ported yet")
        attributes = ["annotations"]
        if config.get("use_features", False):
            attributes.append("features")
        data_dir = config.get("data_dir", None)
        for attribute in attributes:
            for split, paths in (config.get(attribute, {}) or {}).items():
                if isinstance(paths, str):
                    paths = [paths]
                for entry in paths:
                    for path in entry.split(","):
                        if not os.path.isabs(path) and data_dir:
                            path = os.path.join(data_dir, path)
                        path = get_absolute_path(path)
                        if not os.path.exists(path):
                            requirements = config.get("zoo_requirements",
                                                      [self.dataset_name])
                            raise RuntimeError(
                                f"{self.dataset_name}: the {split} "
                                f"{attribute} file {path} is missing. The "
                                "port downloads nothing: put the zoo's "
                                f"{list(requirements)} data there, or point "
                                f"dataset_config.{self.dataset_name}."
                                f"{attribute}.{split} at a local copy"
                            )

    def load(self, config, dataset_type, *args, **kwargs):
        """(reference mmf_dataset_builder.py:125-147)"""
        self.config = config
        annotations = self._read_annotations(config, dataset_type)
        if annotations is None:
            return None
        datasets = [self.dataset_class(config, dataset_type, imdb_idx)
                    for imdb_idx in range(len(annotations))]
        self.dataset = MMFConcatDataset(datasets)
        return self.dataset

    def load_dataset(self, config, dataset_type="train", *args, **kwargs):
        dataset = self.load(config, dataset_type, *args, **kwargs)
        if dataset is not None:
            for d in dataset.datasets:
                d.init_processors()
        return dataset

    def _read_annotations(self, config, dataset_type):
        annotations = config.get("annotations", {}).get(dataset_type, [])
        if isinstance(annotations, str):
            annotations = [annotations]
        if len(annotations) == 0:
            warnings.warn(
                f"Dataset type {dataset_type} is not present or empty in "
                "annotations of dataset config or either annotations key "
                "is not present. Returning None. This dataset won't be used."
            )
            return None
        return annotations
