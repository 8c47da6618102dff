"""Host-side data loading: JAX's batches through torch's DataLoader.

Port of ``mmf_tpu/datasets/loader.py``. JAX prefetches on a thread; the
port's train step is bound by Python launches on the host, so a loader
thread would compete with it for the interpreter lock. The port loads
and collates in ``torch.utils.data.DataLoader`` worker processes
(``training.num_workers``), forked as torch forks them by default on
Linux: a worker starts at once with the dataset inherited (a spawned
one must import torch and the port again first), and it runs only
dataset code, never CUDA. The batches can be pinned
(``training.pin_memory``), so that the trainer's copy to the card is
asynchronous.

The order is JAX's: ``EpochSampler`` draws each epoch's permutation
(``numpy.random.default_rng(seed + epoch)``) and ``EpochBatchSampler``
cuts it into batches, so the port sees the batches JAX sees. Train drops
the short last batch; evaluation keeps it, and ``BatchCollator`` pads it
to the batch size by cycling its samples and records the true size,
which the trainer trims back to.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np
import torch.utils.data

from mmf_tpu_torch.common.batch_collator import BatchCollator


class EpochSampler:
    """Deterministic per-epoch shuffling and per-process sharding (the
    DistributedSampler analog)."""

    def __init__(self, dataset_size: int, shuffle: bool = True, seed: int = 0,
                 num_replicas: int = 1, rank: int = 0):
        self.dataset_size = dataset_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        # pad to a multiple of num_replicas by wrapping, so that every
        # rank yields the same number of indices
        total = self._padded_size()
        if total > order.shape[0]:
            order = np.concatenate([order, order[:total - order.shape[0]]])
        return iter(order[self.rank::self.num_replicas].tolist())

    def _padded_size(self) -> int:
        r = self.num_replicas
        return ((self.dataset_size + r - 1) // r) * r

    def __len__(self) -> int:
        return self._padded_size() // self.num_replicas


class EpochBatchSampler:
    """The sampler's indices in batches of ``batch_size``; the short last
    batch is dropped with ``drop_last`` and kept otherwise."""

    def __init__(self, sampler: EpochSampler, batch_size: int,
                 drop_last: bool):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DataLoader(torch.utils.data.DataLoader):
    """``torch.utils.data.DataLoader`` over an ``EpochSampler``'s
    batches; ``set_epoch`` reseeds the order."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 sampler: Optional[EpochSampler] = None,
                 drop_last: bool = True, num_workers: int = 0,
                 pin_memory: bool = False, persistent_workers: bool = False,
                 seed: int = 0):
        if sampler is None:
            sampler = EpochSampler(len(dataset), shuffle=False, seed=seed)
        self.epoch_sampler = sampler
        workers = max(0, int(num_workers))
        super().__init__(
            dataset,
            batch_sampler=EpochBatchSampler(sampler, batch_size, drop_last),
            collate_fn=collate_fn or BatchCollator("unknown", "train"),
            num_workers=workers,
            pin_memory=pin_memory,
            persistent_workers=bool(persistent_workers) and workers > 0,
        )

    def set_epoch(self, epoch: int):
        self.epoch_sampler.set_epoch(epoch)

    def shutdown(self):
        """Stop the persistent worker processes now; a later iteration
        starts new ones. (Left to a garbage collection of the reference
        cycles that hold the loader, their queues may go first, and each
        worker is then stopped only after a 5 s timeout.)"""
        self._iterator = None


def build_dataloader_and_sampler(dataset, training_config, dataset_type="train",
                                 batch_size=None, seed=0):
    """The split's loader and its sampler (reference utils/build.py:264-340):
    train shuffles and drops the short last batch; evaluation keeps the
    order and pads the last batch (trimmed after the forward), so every
    sample is scored once."""
    from mmf_tpu_torch.utils.distributed import get_rank, get_world_size

    if batch_size is None:
        from mmf_tpu_torch.utils.general import get_batch_size

        batch_size = get_batch_size()

    train = dataset_type == "train"
    sampler = EpochSampler(
        len(dataset),
        shuffle=train,
        seed=seed,
        num_replicas=get_world_size(),
        rank=get_rank(),
    )
    collate = BatchCollator(
        getattr(dataset, "dataset_name", "unknown"),
        getattr(dataset, "dataset_type", dataset_type),
        pad_to=None if train else batch_size,
    )
    loader = DataLoader(
        dataset,
        batch_size=batch_size,
        collate_fn=collate,
        sampler=sampler,
        drop_last=train,
        num_workers=training_config.get("num_workers", 4),
        pin_memory=training_config.get("pin_memory", False),
        persistent_workers=training_config.get("persistent_workers", True),
    )
    loader.dataset_name = getattr(dataset, "dataset_name", "unknown")
    loader.dataset_type = dataset_type
    return loader, sampler
