"""Multi-dataset iteration strategies.

Port of ``mmf_tpu/datasets/iteration_strategies.py``: a strategy picks
which dataset's loader supplies the next batch (one process decides).
"""

from __future__ import annotations

import logging
import warnings
from typing import Dict

import numpy as np

from mmf_tpu_torch.common.registry import registry

logger = logging.getLogger(__name__)


class IterationStrategy:
    def __init__(self, config, dataloaders: Dict[str, object], *args, **kwargs):
        self.config = config or {}
        self.dataloaders = dataloaders

    @classmethod
    def from_params(cls, dataloaders: Dict[str, object], **kwargs):
        return cls(kwargs, dataloaders)

    @property
    def should_exhaust_all_iterators(self) -> bool:
        # eval loaders opt in via config: exhausted datasets then finish
        # the epoch instead of being reignited forever
        return bool((self.config or {}).get("exhaust_all", False))

    def _check_not_epoch_training(self):
        if (self.config or {}).get("skip_epoch_check", False):
            return
        config = registry.get("config", no_warning=True)
        if config is not None:
            assert config["training"].get("max_epochs", None) is None, (
                f"{self.__class__.__name__} doesn't make sense with "
                "epoch based training"
            )

    def __call__(self, *args, **kwargs) -> int:
        raise NotImplementedError


@registry.register_iteration_strategy("constant")
class ConstantIterationStrategy(IterationStrategy):
    """Always the same index; mimics single-task training."""

    def __init__(self, config, dataloaders, *args, **kwargs):
        super().__init__(config, dataloaders, *args, **kwargs)
        self._idx = (config or {}).get("idx", 0)

    @property
    def should_exhaust_all_iterators(self) -> bool:
        return True

    def __call__(self, *args, **kwargs) -> int:
        return self._idx


@registry.register_iteration_strategy("round_robin")
class RoundRobinIterationStrategy(IterationStrategy):
    """Cycle through datasets in order."""

    def __init__(self, config, dataloaders, *args, **kwargs):
        super().__init__(config, dataloaders, *args, **kwargs)
        self._check_not_epoch_training()
        if "start_idx" in (config or {}):
            self._current_idx = config["start_idx"]
        else:
            self._current_idx = 0

    def __call__(self, *args, **kwargs) -> int:
        nxt = self._current_idx
        self._current_idx = (self._current_idx + 1) % len(self.dataloaders)
        return nxt


@registry.register_iteration_strategy("random")
class RandomIterationStrategy(IterationStrategy):
    def __init__(self, config, dataloaders, *args, **kwargs):
        super().__init__(config, dataloaders, *args, **kwargs)
        self._check_not_epoch_training()

    def __call__(self, *args, **kwargs) -> int:
        return int(np.random.choice(len(self.dataloaders), 1)[0])


@registry.register_iteration_strategy("size_proportional")
class SizeProportionalIterationStrategy(IterationStrategy):
    """Sample datasets proportionally to their size (MMF default)."""

    def __init__(self, config, dataloaders, *args, **kwargs):
        super().__init__(config, dataloaders, *args, **kwargs)
        self._per_dataset_lengths = []
        self._total_length = 0
        for loader in self.dataloaders.values():
            assert hasattr(loader, "dataset"), (
                "loaders need dataset objects to work with "
                "'size_proportional' sampling"
            )
            n = len(loader.dataset)
            assert n, f"dataset {getattr(loader, 'dataset_name', '?')} is empty"
            self._per_dataset_lengths.append(n)
            self._total_length += n
        self._dataset_probabilities = [
            length / self._total_length for length in self._per_dataset_lengths
        ]

    def __call__(self, *args, **kwargs) -> int:
        return int(
            np.random.choice(
                len(self.dataloaders), 1, p=self._dataset_probabilities
            )[0]
        )

    @property
    def should_exhaust_all_iterators(self) -> bool:
        return True


@registry.register_iteration_strategy("ratios")
class RatiosIterationStrategy(IterationStrategy):
    """Sample by user-specified per-dataset ratios."""

    def __init__(self, config, dataloaders, *args, **kwargs):
        super().__init__(config, dataloaders, *args, **kwargs)
        self._check_not_epoch_training()
        given_datasets = self._get_given_datasets()
        sampling_ratios = (config or {}).get("sampling_ratios", {})
        probabilities = []
        for dataset in given_datasets:
            assert dataset in sampling_ratios, (
                f"{dataset} must be specified in sampling_ratios param "
                "for multitasking"
            )
            probabilities.append(sampling_ratios[dataset])
        prob_sum = sum(probabilities)
        assert all(p >= 0 for p in probabilities) and prob_sum > 0, (
            "sampling_ratios must be non-negative with at least one positive"
        )
        self._dataset_probabilities = [p / prob_sum for p in probabilities]
        logger.info("Using per-dataset sampling probabilities:")
        for dataset, prob in zip(given_datasets, self._dataset_probabilities):
            logger.info(f"\t{dataset}: {prob}")

    def __call__(self, *args, **kwargs) -> int:
        return int(
            np.random.choice(
                len(self.dataloaders), 1, p=self._dataset_probabilities
            )[0]
        )

    def _get_given_datasets(self):
        config = registry.get("config", no_warning=True)
        datasets = None
        if config is not None and "datasets" in config:
            d = config["datasets"]
            datasets = d.split(",") if isinstance(d, str) else list(d)
        if not datasets:
            warnings.warn(
                "'datasets' key not in global config or empty; using the "
                "sampling_ratios keys"
            )
            return list((self.config or {}).get("sampling_ratios", {}).keys())
        return [d.strip() for d in datasets]
