"""``Report``: merged view of a batch and the model output.

Port of ``mmf_tpu/common/report.py``: merges ``SampleList`` fields with
the model-output dict (losses, scores, ...), warns on key collisions,
and accumulates fields across eval batches for split-level metrics.
``to_numpy`` brings tensors to the host as numpy arrays (bfloat16 as
float32, which numpy lacks); accumulation concatenates on the host, so
an eval sweep holds no logits on the card.
"""

from __future__ import annotations

import collections
import collections.abc
import warnings
from typing import Any, Callable, Dict, List

import numpy as np

import torch

from mmf_tpu_torch.common.sample import SampleList, _is_array


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x) if _is_array(x) else x


class Report(collections.OrderedDict):
    def __init__(self, batch: SampleList = None, model_output: Dict[str, Any] = None,
                 *args):
        super().__init__()
        if batch is None:
            return
        if model_output is None:
            model_output = {}
        all_args = [batch, model_output] + list(args)
        for idx, arg in enumerate(all_args):
            if not isinstance(arg, collections.abc.Mapping):
                raise TypeError(
                    "Argument {:d}, {} must be of instance of "
                    "collections.abc.Mapping".format(idx, arg)
                )

        self.batch_size = batch.get_batch_size() if isinstance(batch, SampleList) else None
        self.warning_string = (
            "Updating forward report with key {}"
            "{}, but it already exists in {}. "
            "Please consider using a different key, "
            "as this can cause issues during loss and "
            "metric calculations."
        )

        for idx, arg in enumerate(all_args):
            fields = arg.fields() if isinstance(arg, SampleList) else list(arg.keys())
            for field in fields:
                if field in self and field != "_tensor_field" and idx >= 1:
                    log = self.warning_string.format(
                        field, "", f"previous arguments to report"
                    )
                    warnings.warn(log)
                self[field] = arg[field]

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        if key.startswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def fields(self) -> List[str]:
        return [k for k in self.keys() if k != "_tensor_field"]

    # -- functional application (reference report.py:85-154) -------------
    def apply_fn(self, fn: Callable, fields: List[str] = None) -> "Report":
        for field in self.keys():
            if fields is not None and field not in fields:
                continue
            self[field] = fn(self[field])
            if isinstance(self[field], collections.abc.MutableSequence):
                for idx, item in enumerate(self[field]):
                    self[field][idx] = fn(item)
            elif isinstance(self[field], dict):
                for key in self[field].keys():
                    self[field][key] = fn(self[field][key])
        return self

    def detach(self) -> "Report":
        return self

    def to_numpy(self, fields: List[str] = None) -> "Report":
        return self.apply_fn(_to_numpy, fields)

    def trim_to_batch_size(self, n: int) -> "Report":
        """Drop padded tail rows: slice every array/list field whose leading
        dim is a multiple k of the padded batch size down to ``k*n``. Used
        when eval loaders pad the final batch to the loader's batch size.

        k>1 covers sample-major fan-outs — e.g. retrieval eval flattens
        (B, factor, ...) caption stacks to (B*factor, ...), so each
        sample's rows are contiguous and a prefix slice keeps exactly the
        real samples' rows."""
        padded = self.batch_size
        if padded is None or n >= padded:
            return self
        for key in self.fields():
            v = self[key]
            if (_is_array(v) and v.ndim >= 1 and v.shape[0] > 0
                    and v.shape[0] % padded == 0):
                k = v.shape[0] // padded
                self[key] = v[: k * n]
            elif isinstance(v, list) and len(v) == padded:
                self[key] = v[:n]
        self.batch_size = n
        return self

    # -- eval accumulation (reference report.py:156-184) -----------------
    def accumulate_tensor_fields_and_loss(
        self, report: "Report", field_list: List[str]
    ) -> None:
        for key in field_list:
            if key == "__prediction_report__":
                continue
            if key not in self.keys():
                warnings.warn(
                    f"{key} not found in report. Metrics calculation "
                    "might not work as expected."
                )
                continue
            if _is_array(self[key]):
                self[key] = np.concatenate(
                    (np.asarray(self[key]), np.asarray(report[key])), axis=0
                )
            elif isinstance(self[key], list):
                self[key].extend(report[key])

        self._accumulate_loss(report)

    def _accumulate_loss(self, report: "Report") -> None:
        for key, value in report.losses.items():
            if key not in self.losses:
                self.losses[key] = np.asarray(value)
            else:
                self.losses[key] = np.asarray(self.losses[key]) + np.asarray(value)

    def copy(self) -> "Report":
        out = Report.__new__(Report)
        collections.OrderedDict.__init__(out)
        for k in self.keys():
            out[k] = self[k]
        return out
