"""Collate function stamping dataset identity onto each batch.

Port of ``mmf_tpu/common/batch_collator.py``. With ``pad_to`` a short
batch (an eval split's last) is filled up to ``pad_to`` by cycling its
samples, as the JAX loader pads it (``loader.py:114-123``), and carries
its true size as ``_true_batch_size`` so that evaluation can trim the
padded rows. It runs in the loader's worker processes, so it is a
picklable object, not a closure.
"""

from typing import Optional

from mmf_tpu_torch.common.sample import SampleList


class BatchCollator:
    def __init__(self, dataset_name: str, dataset_type: str,
                 pad_to: Optional[int] = None):
        self._dataset_name = dataset_name
        self._dataset_type = dataset_type
        self._pad_to = pad_to

    def __call__(self, batch):
        n_valid = None
        if not isinstance(batch, SampleList):
            if self._pad_to is not None and len(batch) < self._pad_to:
                n_valid = len(batch)
                batch = [batch[i % n_valid] for i in range(self._pad_to)]
            batch = SampleList(batch)
        batch.dataset_name = self._dataset_name
        batch.dataset_type = self._dataset_type
        if n_valid is not None:
            batch._true_batch_size = n_valid
        return batch
