"""The f1, f1_precision_recall, roc_auc and ap families of the port
(numpy) against the JAX package's (sklearn) on the same reports, within
1e-12: random reports, tied scores, no positive prediction, one class in
the split (sklearn's NaN with a warning for ROC AUC; its errors where it
raises), soft and multilabel targets."""

import warnings

import numpy as np
import pytest

TOL = 1e-12
METRICS = [
    "f1", "macro_f1", "micro_f1", "binary_f1", "multilabel_f1",
    "multilabel_micro_f1", "multilabel_macro_f1",
    "f1_precision_recall", "binary_f1_precision_recall",
    "macro_f1_precision_recall", "micro_f1_precision_recall",
    "roc_auc", "micro_roc_auc", "macro_roc_auc",
    "ap", "binary_ap", "micro_ap", "macro_ap",
]


def _pair(name):
    from mmf_tpu.common.registry import registry as jreg
    from mmf_tpu.utils.env import setup_imports as jsetup
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.utils.env import setup_imports

    jsetup()
    setup_imports()
    return (jreg.get_metric_class(name)(),
            registry.get_metric_class(name)())


def _report(kind, n=24, classes=2, seed=0):
    rng = np.random.RandomState(seed)
    scores = rng.randn(n, classes).astype(np.float32)
    targets = rng.randint(0, classes, n)
    if kind == "ties":
        # scores on a coarse grid: many equal probabilities
        scores = np.round(scores * 2) / 2
    elif kind == "no_positive_prediction":
        scores[:, 0] += 10.0
    elif kind == "one_class":
        targets[:] = 0
    elif kind == "soft":
        soft = rng.rand(n, classes).astype(np.float32)
        return scores, soft / soft.sum(1, keepdims=True)
    elif kind == "multilabel":
        return scores, (rng.rand(n, classes) < 0.4).astype(np.float32)
    return scores, targets


def _call(metric, scores, targets):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return metric.calculate({"targets": targets}, {"scores": scores})
        except ValueError as e:
            return e


def _close(got, want):
    if isinstance(want, ValueError):
        return isinstance(got, ValueError)
    if isinstance(want, dict):
        return set(got) == set(want) and all(
            _close(got[k], want[k]) for k in want)
    if np.isnan(want):
        return np.isnan(got)
    return abs(float(got) - float(want)) <= TOL


KINDS = ["random", "ties", "no_positive_prediction", "one_class"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax_binary(name, kind):
    jm, pm = _pair(name)
    scores, targets = _report(kind)
    want, got = _call(jm, scores, targets), _call(pm, scores, targets)
    assert _close(got, want), (got, want)


@pytest.mark.parametrize("kind", ["random", "ties", "soft", "multilabel"])
@pytest.mark.parametrize("name", [m for m in METRICS if "binary" not in m])
def test_metric_matches_jax_three_classes(name, kind):
    jm, pm = _pair(name)
    scores, targets = _report(kind, n=30, classes=3, seed=1)
    want, got = _call(jm, scores, targets), _call(pm, scores, targets)
    assert _close(got, want), (got, want)


def test_the_errors_and_nans_are_sklearn_s():
    """A three-class target under ``average='binary'`` raises in both;
    a one-class split gives ROC AUC NaN in both, with a warning."""
    jm, pm = _pair("binary_f1")
    scores, targets = _report("random", n=30, classes=3, seed=2)
    for m in (jm, pm):
        with pytest.raises(ValueError, match="binary"):
            m.calculate({"targets": targets}, {"scores": scores})
    scores, targets = _report("one_class")
    for m in _pair("roc_auc"):
        with pytest.warns(Warning, match="(?i)one class"):
            assert np.isnan(m.calculate({"targets": targets},
                                        {"scores": scores}))


def test_metrics_report_under_their_keys():
    from mmf_tpu_torch.modules.metrics import Metrics

    scores, targets = _report("random")
    values = Metrics(["accuracy", "binary_f1", "roc_auc",
                      "binary_f1_precision_recall"])(
        {"targets": targets, "dataset_name": "hateful_memes",
         "dataset_type": "val"}, {"scores": scores})
    assert set(values) == {
        "val/hateful_memes/accuracy", "val/hateful_memes/binary_f1",
        "val/hateful_memes/roc_auc",
        "val/hateful_memes/binary_f1_precision_recall/precision",
        "val/hateful_memes/binary_f1_precision_recall/recall",
        "val/hateful_memes/binary_f1_precision_recall/f1"}
    assert all(v.dtype == np.float32 for v in values.values())
