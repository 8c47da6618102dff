"""Metrics.

Port of ``mmf_tpu/modules/metrics.py``: ``Metrics`` builds the configured
metric list and names each result ``<type>/<dataset>/<metric>``;
``accuracy`` and ``vqa_accuracy`` are ported. Metrics run on the host
over the gathered report (numpy in, numpy out), as JAX's do; the trainer
accumulates the fields in ``Metrics.required_params``. The other metrics
wait for the models and datasets that use them.
"""

from __future__ import annotations

import collections.abc

import numpy as np

from mmf_tpu_torch.common.registry import registry


def _to_np(x):
    return np.asarray(x)


class Metrics:
    """Wrapper initializing and applying the configured metric list."""

    def __init__(self, metric_list):
        if not isinstance(metric_list, collections.abc.Sequence) or isinstance(
            metric_list, str
        ):
            metric_list = [metric_list]
        self.metrics = self._init_metrics(metric_list)

    def _init_metrics(self, metric_list):
        metrics = {}
        self.required_params = {"dataset_name", "dataset_type"}
        for entry in metric_list:
            key, instance = self._build_one(entry, metrics)
            metrics[key] = instance
            self.required_params.update(instance.required_params)
        return metrics

    @staticmethod
    def _build_one(entry, existing):
        """One metric-list entry (plain string, or a mapping with
        type/key/params/datasets) -> (report key, metric instance)."""
        params, dataset_names = {}, []
        if isinstance(entry, str):
            metric_type = key = entry
        elif isinstance(entry, collections.abc.Mapping):
            if "type" not in entry:
                raise ValueError(
                    f"Metric config {entry} carries no 'type' key"
                )
            metric_type = entry["type"]
            key = entry.get("key", metric_type)
            params = entry.get("params", {})
            dataset_names = entry.get("datasets", [])
            if key in existing:
                raise RuntimeError(
                    f"Duplicate metric key '{key}' in the metric list"
                )
        else:
            raise TypeError(
                f"Metric entry must be a str or mapping, got "
                f"{type(entry).__name__}"
            )
        cls = registry.get_metric_class(metric_type)
        if cls is None:
            raise ValueError(
                f"Unknown metric '{metric_type}': nothing registered "
                "under that key"
            )
        instance = cls(**params)
        instance.name = key
        instance.set_applicable_datasets(dataset_names)
        return key, instance

    def __call__(self, sample_list, model_output=None, *args, **kwargs):
        if model_output is None:
            model_output = sample_list  # combined report carries both
        values = {}
        dataset_type = _meta(sample_list, "dataset_type")
        dataset_name = _meta(sample_list, "dataset_name")

        for metric_name, metric_object in self.metrics.items():
            if not metric_object.is_dataset_applicable(dataset_name):
                continue
            metric_result = metric_object._calculate_with_checks(
                sample_list, model_output, *args, **kwargs
            )
            if not isinstance(metric_result, collections.abc.Mapping):
                metric_result = {"": metric_result}
            for child_name, child_result in metric_result.items():
                key = f"{dataset_type}/{dataset_name}/{metric_name}"
                key = f"{key}/{child_name}" if child_name else key
                values[key] = np.asarray(child_result, dtype=np.float32)

        registry.register(
            f"metrics.{dataset_name}.{dataset_type}", values
        )
        return values


def _meta(sample_list, key):
    val = sample_list.get(key, None) if hasattr(sample_list, "get") else None
    if isinstance(val, list):
        return val[0] if val else "unknown"
    return val if val is not None else (
        "train" if key == "dataset_type" else "unknown"
    )


class BaseMetric:
    """Base for registered metrics; subclasses implement ``calculate``
    (reference metrics.py:205-240)."""

    def __init__(self, name, *args, **kwargs):
        self.name = name
        self.required_params = ["scores", "targets"]
        self._dataset_names = set()

    def calculate(self, sample_list, model_output, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.calculate(*args, **kwargs)

    def _calculate_with_checks(self, *args, **kwargs):
        return self.calculate(*args, **kwargs)

    def set_applicable_datasets(self, dataset_names):
        self._dataset_names = set(dataset_names)

    def is_dataset_applicable(self, dataset_name):
        return len(self._dataset_names) == 0 or dataset_name in self._dataset_names


# ---------------------------------------------------------------------------
@registry.register_metric("accuracy")
class Accuracy(BaseMetric):
    """**Key:** ``accuracy`` (reference metrics.py:243)."""

    def __init__(self, score_key="scores", target_key="targets", topk=1):
        super().__init__("accuracy")
        self.score_key = score_key
        self.target_key = target_key
        self.topk = topk

    def calculate(self, sample_list, model_output, *args, **kwargs):
        output = _to_np(model_output[self.score_key])
        expected = _to_np(sample_list[self.target_key])
        batch_size = output.shape[0]
        assert output.ndim <= 2 and expected.ndim <= 2

        if output.ndim == 2:
            top = np.argsort(-output, axis=1)[:, : self.topk].T.squeeze()
        else:
            top = output
        if expected.ndim == 2 and expected.shape[-1] != 1:
            expected = np.argsort(-expected, axis=1)[:, : self.topk].T.squeeze()
        correct = float(np.sum(expected == np.squeeze(top)))
        return correct / batch_size


@registry.register_metric("vqa_accuracy")
class VQAAccuracy(BaseMetric):
    """Soft VQA accuracy: argmax over UNK-masked softmax scored against the
    soft target vector (reference metrics.py:355)."""

    def __init__(self):
        super().__init__("vqa_accuracy")

    def _masked_unk_softmax(self, x, axis, mask_idx):
        x = x - x.max(axis=axis, keepdims=True)
        ex = np.exp(x)
        x1 = ex / ex.sum(axis=axis, keepdims=True)
        x1[:, mask_idx] = 0
        return x1 / x1.sum(axis=1, keepdims=True)

    def calculate(self, sample_list, model_output, *args, **kwargs):
        output = _to_np(model_output["scores"]).astype(np.float64)
        if output.ndim == 3:  # three-branch movie+mcan
            output = output[:, 0]
        expected = _to_np(sample_list["targets"])
        output = self._masked_unk_softmax(output, 1, 0)
        pred = output.argmax(axis=1)
        scores = expected[np.arange(expected.shape[0]), pred]
        return float(np.sum(scores)) / expected.shape[0]
