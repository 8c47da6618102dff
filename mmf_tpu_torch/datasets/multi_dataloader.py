"""MultiDataLoader: one iterator over many dataset loaders.

Port of ``mmf_tpu/datasets/multi_dataloader.py``: the iteration strategy
picks each batch's dataset (one process, so nothing to broadcast), with
the exhaust-or-reignite semantics, and each batch leaves as a
``SampleList`` stamped with its dataset's name and split.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator

from mmf_tpu_torch.common.sample import (
    SampleList,
    convert_batch_to_sample_list,
)
from mmf_tpu_torch.datasets import iteration_strategies

logger = logging.getLogger(__name__)


class MultiDataLoader:
    def __init__(self, loaders: Dict[str, object], iteration_strategy=None):
        if loaders is None or len(loaders) == 0:
            logger.warning(
                "Empty loaders passed into MultiDataLoader. This can have "
                "unintended consequences."
            )
        if iteration_strategy is None:
            iteration_strategy = iteration_strategies.RoundRobinIterationStrategy(
                {}, loaders
            )
        self._iteration_strategy = iteration_strategy
        self._loaders = loaders
        self._num_datasets = len(loaders)
        self.dataset_list = list(loaders.keys())
        self._iterators = {}
        self._finished_iterators = {}
        self.current_index = 0
        self._total_length = sum(
            len(loader.dataset) for loader in loaders.values()
            if hasattr(loader, "dataset") and hasattr(loader.dataset, "__len__")
        )

    # -- properties (parity) --------------------------------------------
    @property
    def loaders(self):
        return self._loaders

    @property
    def num_datasets(self):
        return self._num_datasets

    @property
    def iterators(self) -> Dict[str, Iterator]:
        return self._iterators

    @property
    def current_loader(self):
        return self.loaders[self.current_dataset_name]

    @property
    def iteration_strategy(self):
        return self._iteration_strategy

    @property
    def current_iterator(self):
        return self._iterators[self.current_dataset_name]

    @property
    def current_dataset_name(self) -> str:
        return self.dataset_list[self.current_index]

    @property
    def current_dataset(self):
        return getattr(self.current_loader, "dataset", None)

    @property
    def first_loader(self):
        return list(self.loaders.values())[0]

    def __len__(self) -> int:
        # inner loaders know their own drop-last (train) / pad-last (eval)
        # batch accounting
        return sum(len(loader) for loader in self.loaders.values())

    def __iter__(self):
        self._finished_iterators = {}
        self._iterators = {}
        for key, loader in self.loaders.items():
            self._iterators[key] = iter(loader)
        self.change_dataloader()
        return self

    def __next__(self) -> SampleList:
        if self.num_datasets == 0:
            # every dataset skipped this split ("This dataset won't be
            # used"): an empty epoch, not a crash
            raise StopIteration
        try:
            next_batch = next(self.current_iterator)
        except StopIteration:
            if self.iteration_strategy.should_exhaust_all_iterators:
                self._finished_iterators[self.current_dataset_name] = 1
                # keep rotating: a freshly chosen loader may itself be at
                # its end (unequal dataset sizes) — mark and move on
                while True:
                    if len(self._finished_iterators) == self.num_datasets:
                        raise
                    self.change_dataloader()
                    try:
                        next_batch = next(self.current_iterator)
                        break
                    except StopIteration:
                        self._finished_iterators[
                            self.current_dataset_name
                        ] = 1
            else:
                self._iterators[self.current_dataset_name] = iter(
                    self.current_loader
                )
                next_batch = next(self.current_iterator)

        current_dataset_name = self.current_dataset_name
        current_dataset_type = getattr(
            self.current_dataset, "dataset_type", "train"
        )

        next_batch = self.prepare_batch(next_batch)
        next_batch = convert_batch_to_sample_list(next_batch)
        next_batch.dataset_name = current_dataset_name
        next_batch.dataset_type = current_dataset_type
        return next_batch

    def change_dataloader(self):
        if self.num_datasets <= 1:
            self.current_index = 0
            return
        choice = self.iteration_strategy()
        while self.dataset_list[choice] in self._finished_iterators:
            choice = self.iteration_strategy()
        self.current_index = int(choice)

    def prepare_batch(self, batch):
        if self.current_dataset and hasattr(self.current_dataset, "prepare_batch"):
            batch = self.current_dataset.prepare_batch(batch)
        self.change_dataloader()
        return batch

    def seed_sampler(self, epoch: int):
        for loader in self.loaders.values():
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)

    def set_epoch(self, epoch: int):
        self.seed_sampler(epoch)

    def teardown(self):
        """Stop the loaders' worker processes (see ``DataLoader.shutdown``)."""
        self._iterators = {}
        for loader in self.loaders.values():
            if hasattr(loader, "shutdown"):
                loader.shutdown()
