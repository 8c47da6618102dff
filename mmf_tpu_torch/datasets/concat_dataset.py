"""Concatenated datasets.

Port of ``MMFConcatDataset`` from ``mmf_tpu/datasets/concat_dataset.py``:
one dataset over a split's imdb files, which forwards other attributes
(processors, ``format_for_prediction``) to the first of them.
"""

from __future__ import annotations

import bisect
from typing import List


class MMFConcatDataset:
    def __init__(self, datasets: List):
        if not datasets:
            raise ValueError("MMFConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = self._cumsum(self.datasets)
        self._dataset_name = getattr(datasets[0], "dataset_name", None)
        self._dataset_type = getattr(datasets[0], "dataset_type", None)

    @staticmethod
    def _cumsum(sequence):
        r, s = [], 0
        for e in sequence:
            s += len(e)
            r.append(s)
        return r

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = (
            idx if dataset_idx == 0
            else idx - self.cumulative_sizes[dataset_idx - 1]
        )
        return self.datasets[dataset_idx][sample_idx]

    @property
    def dataset_name(self):
        return self._dataset_name

    @dataset_name.setter
    def dataset_name(self, name):
        self._dataset_name = name

    @property
    def dataset_type(self):
        return self._dataset_type

    @dataset_type.setter
    def dataset_type(self, dtype):
        self._dataset_type = dtype

    def __getattr__(self, name):
        if name.startswith("_") or name in ("datasets", "cumulative_sizes"):
            raise AttributeError(name)
        return getattr(self.datasets[0], name)
