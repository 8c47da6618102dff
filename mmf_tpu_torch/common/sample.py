"""``Sample`` and ``SampleList``: the data currency of the port.

Port of ``mmf_tpu/common/sample.py``. A ``Sample`` is an attribute-dict
of one example's fields: numpy arrays or CPU tensors from the
processors, plus metadata (strings, token lists). A ``SampleList`` is
the batched form: construction stacks every array field into a CPU
tensor along a new leading batch axis (numpy fields through
``torch.from_numpy``), ints become int32 and floats float32 tensors, and
other fields become lists. It is an ``OrderedDict``, so a model takes it
as the dict it expects.

``pytree()`` gives the tensor fields alone (nested ``SampleList``s as
nested dicts): the part that crosses to the card. ``to(device,
non_blocking=True)`` moves the tensors and keeps the metadata;
``pin_memory()`` pins them (the loader's ``pin_memory`` calls it). The
loader's padded last eval batch carries its true size as the attribute
``_true_batch_size``, which both keep.
"""

from __future__ import annotations

import collections
import collections.abc
from typing import Any, Dict, List, Union

import numpy as np
import torch
import torch.utils.data

_ATTRS = ("_true_batch_size",)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _stack(values) -> torch.Tensor:
    """The values stacked along a new axis 0. In a loader worker the
    batch is stacked straight into shared memory, as torch's
    ``default_collate`` does, so that handing it to the trainer copies
    nothing more."""
    tensors = [v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v)) for v in values]
    out = None
    if torch.utils.data.get_worker_info() is not None:
        first = tensors[0]
        storage = first._typed_storage()._new_shared(
            len(tensors) * first.numel(), device=first.device)
        out = first.new(storage).resize_(len(tensors), *first.shape)
    return torch.stack(tensors, dim=0, out=out)


class Sample(collections.OrderedDict):
    """A single example: a dict with attribute access."""

    def __init__(self, init_dict=None):
        super().__init__(init_dict or {})

    def __setattr__(self, key, value):
        if isinstance(value, collections.abc.Mapping) and not isinstance(
            value, (Sample, SampleList)
        ):
            value = Sample(value)
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Key {key} not found in the sample. Valid choices are "
                f"{self.fields()}"
            )

    def fields(self) -> List[str]:
        return list(self.keys())


class SampleList(collections.OrderedDict):
    """A batch of Samples with stacked tensor fields."""

    _TENSOR_FIELD = "_tensor_field"

    def __init__(self, samples=None):
        super().__init__()
        if not samples:
            return
        if _is_array(samples[0]) or isinstance(samples[0],
                                               (int, float, np.number)):
            raise TypeError("Pass in a list of Sample/dicts, not raw arrays")

        for field in samples[0].keys():
            value = samples[0][field]
            if isinstance(value, collections.abc.Mapping):
                self[field] = SampleList([
                    s[field] if isinstance(s[field], Sample)
                    else Sample(s[field]) for s in samples
                ])
            elif _is_array(value):
                shapes = {tuple(s[field].shape) for s in samples}
                if len(shapes) != 1:
                    raise AssertionError(
                        f"Fields for all samples must be equally sized. "
                        f"{field} is of different sizes: {sorted(shapes)}"
                    )
                self[field] = _stack([s[field] for s in samples])
                self._set_tensor_field(field)
            elif isinstance(value, (int, np.integer)):
                self[field] = torch.tensor([int(s[field]) for s in samples],
                                           dtype=torch.int32)
                self._set_tensor_field(field)
            elif isinstance(value, (float, np.floating)):
                self[field] = torch.tensor(
                    [float(s[field]) for s in samples], dtype=torch.float32)
                self._set_tensor_field(field)
            else:
                self[field] = [s[field] for s in samples]

    def __setattr__(self, key, value):
        if key in _ATTRS:
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def __getattr__(self, key):
        if key.startswith("__") or key in _ATTRS:
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Key {key} not found in the SampleList. "
                f"Valid choices are {self.fields()}"
            )

    def _set_tensor_field(self, field):
        tf = super().get(SampleList._TENSOR_FIELD, None)
        if tf is None:
            tf = []
            super().__setitem__(SampleList._TENSOR_FIELD, tf)
        if field not in tf:
            tf.append(field)

    def fields(self) -> List[str]:
        return [k for k in self.keys() if k != SampleList._TENSOR_FIELD]

    def get_fields(self, fields):
        out = SampleList()
        for f in fields:
            out.add_field(f, self[f])
        return out

    def get_field(self, field):
        return self[field]

    def get_batch_size(self) -> int:
        for k in self.fields():
            v = self[k]
            if _is_array(v):
                return int(v.shape[0])
            if isinstance(v, SampleList):
                return v.get_batch_size()
            if isinstance(v, list):
                return len(v)
        raise RuntimeError("Empty SampleList has no batch size")

    def add_field(self, field: str, data: Any):
        """Add a field, checking its size against the batch size."""
        if self.fields():
            bs = self.get_batch_size()
            n = None
            if _is_array(data):
                n = data.shape[0] if data.ndim > 0 else None
            elif isinstance(data, SampleList):
                n = data.get_batch_size()
            elif isinstance(data, list):
                n = len(data)
            if n is not None and n != bs:
                raise AssertionError(
                    f"A batch size mismatch was detected when adding field "
                    f"{field}: expected {bs}, got {n}"
                )
        self[field] = data
        if _is_array(data):
            self._set_tensor_field(field)
        return self

    def _map_tensors(self, fn) -> "SampleList":
        out = SampleList()
        for k in self.fields():
            v = self[k]
            if isinstance(v, torch.Tensor):
                v = fn(v)
            elif isinstance(v, SampleList):
                v = v._map_tensors(fn)
            out.add_field(k, v)
        for attr in _ATTRS:
            if attr in self.__dict__:
                object.__setattr__(out, attr, self.__dict__[attr])
        return out

    def copy(self) -> "SampleList":
        return self._map_tensors(lambda t: t)

    def pytree(self) -> Dict[str, Any]:
        """The tensor fields alone, as a (nested) plain dict."""
        out = {}
        for k in self.fields():
            v = self[k]
            if _is_array(v):
                out[k] = v
            elif isinstance(v, SampleList):
                sub = v.pytree()
                if sub:
                    out[k] = sub
        return out

    def meta(self) -> Dict[str, Any]:
        """The fields that are not tensors (strings, token lists, dataset
        tags)."""
        out = {}
        for k in self.fields():
            v = self[k]
            if _is_array(v):
                continue
            if isinstance(v, SampleList):
                sub = v.meta()
                if sub:
                    out[k] = sub
            else:
                out[k] = v
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {k: self[k] for k in self.fields()}

    def detach(self) -> "SampleList":
        return self._map_tensors(lambda t: t.detach())

    def to(self, device, non_blocking: bool = False) -> "SampleList":
        """The tensors moved to ``device``; metadata stays on the host."""
        return self._map_tensors(
            lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "SampleList":
        return self._map_tensors(lambda t: t.pin_memory())


def convert_batch_to_sample_list(
    batch: Union[SampleList, Dict[str, Any], List[Sample]]
) -> SampleList:
    if isinstance(batch, SampleList):
        return batch
    if isinstance(batch, collections.abc.Mapping):
        sl = SampleList()
        for k, v in batch.items():
            sl.add_field(k, v)
        return sl
    return SampleList(batch)
