"""Metrics.

Port of ``mmf_tpu/modules/metrics.py``: ``Metrics`` builds the configured
metric list and names each result ``<type>/<dataset>/<metric>``.
Ported: ``accuracy``, ``vqa_accuracy`` and the families JAX computes
with sklearn, written here in numpy (the card's machine has no sklearn)
with sklearn's semantics: ``f1`` (``macro_``, ``micro_``, ``binary_``,
``multilabel_`` and its ``micro``/``macro`` forms),
``f1_precision_recall`` (``binary_``, ``macro_``, ``micro_``),
``roc_auc`` (``micro_``, ``macro_``) and ``ap`` (``binary_``,
``micro_``, ``macro_``), ``textvqa_accuracy`` (M4C's decoded answers
against TextVQA's ten, ``utils/m4c_evaluators``), the M4C family's and
``caption_bleu4`` (BUTD's captions, corpus BLEU-4 without nltk).
Metrics run on the host over the gathered report (numpy in, numpy out), as JAX's do; the
trainer accumulates the fields in ``Metrics.required_params``. The other metrics wait for the
models and datasets that use them.
"""

from __future__ import annotations

import collections.abc
import warnings

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


def _convert_to_one_hot(expected, n_classes):
    """Class indices [N] (or [N, 1]) -> one-hot [N, n_classes]; a wider
    target passes as it is."""
    expected = np.asarray(expected)
    if expected.ndim == 1 or (expected.ndim == 2 and expected.shape[1] == 1):
        idx = expected.reshape(-1).astype(np.int64)
        one_hot = np.zeros((idx.shape[0], n_classes), dtype=np.int64)
        one_hot[np.arange(idx.shape[0]), idx] = 1
        return one_hot
    return expected


def _softmax64(scores):
    scores = _to_np(scores).astype(np.float64)
    scores = np.exp(scores - scores.max(-1, keepdims=True))
    return scores / scores.sum(-1, keepdims=True)


# --- sklearn's semantics in numpy -----------------------------------------
_AVERAGES = (None, "micro", "macro", "weighted")


def _target_type(y):
    """sklearn's ``type_of_target`` for the label arrays the metrics
    see: "continuous" (non-integral values; "-multioutput" in several
    columns), "multilabel-indicator" (several columns of at most two
    integral values), "multiclass-multioutput", "binary" (at most two
    values) or "multiclass"."""
    y = np.asarray(y)
    several = y.ndim == 2 and y.shape[1] > 1
    if y.dtype.kind == "f" and np.any(y != y.astype(int)):
        return "continuous-multioutput" if several else "continuous"
    labels = np.unique(y)
    if several:
        return ("multilabel-indicator" if labels.size < 3
                else "multiclass-multioutput")
    return "binary" if labels.size <= 2 else "multiclass"


def _prf_divide(numerator, denominator):
    """numerator / denominator, 0 where the denominator is 0 (sklearn's
    ``zero_division="warn"``)."""
    numerator = np.asarray(numerator, np.float64)
    denominator = np.asarray(denominator, np.float64)
    out = np.zeros(np.broadcast(numerator, denominator).shape)
    nonzero = denominator != 0
    out[nonzero] = numerator[nonzero] / denominator[nonzero]
    if not nonzero.all():
        warnings.warn("ill-defined metric set to 0.0: a label with no "
                      "predicted or no true samples")
    return out


def precision_recall_fscore(y_true, y_pred, average="binary", pos_label=1):
    """sklearn's ``precision_recall_fscore_support(y_true, y_pred,
    average=...)`` (beta 1): (precision, recall, f1), each a float, or a
    per-label array for ``average=None``."""
    if average not in _AVERAGES and average != "binary":
        raise ValueError(f"average has to be one of {_AVERAGES}")
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    kinds = {_target_type(y_true), _target_type(y_pred)}
    if kinds == {"binary", "multiclass"}:
        kinds = {"multiclass"}
    if len(kinds) > 1:
        raise ValueError("Classification metrics can't handle a mix of "
                         f"{' and '.join(sorted(kinds))} targets")
    kind = kinds.pop()
    if kind not in ("binary", "multiclass", "multilabel-indicator"):
        raise ValueError(f"{kind} is not supported")
    if kind == "multilabel-indicator":
        labels = np.arange(y_true.shape[1])
        true_m, pred_m = y_true != 0, y_pred != 0
    else:
        labels = np.union1d(y_true.ravel(), y_pred.ravel())
        kind = "binary" if labels.size <= 2 else "multiclass"
    if average == "binary":
        if kind != "binary":
            raise ValueError(f"Target is {kind} but average='binary'. "
                             "Please choose another average setting.")
        if pos_label not in labels and labels.size >= 2:
            raise ValueError(f"pos_label={pos_label} is not a valid label. "
                             f"It should be one of {labels.tolist()}")
        labels = np.asarray([pos_label])
    if kind != "multilabel-indicator":
        true_m = y_true.reshape(-1, 1) == labels[None]
        pred_m = y_pred.reshape(-1, 1) == labels[None]
    tp = (true_m & pred_m).sum(0)
    pred_sum, true_sum = pred_m.sum(0), true_m.sum(0)
    if average == "micro":
        tp, pred_sum, true_sum = (np.sum(x, keepdims=True)
                                  for x in (tp, pred_sum, true_sum))
    precision = _prf_divide(tp, pred_sum)
    recall = _prf_divide(tp, true_sum)
    f_score = _prf_divide(2.0 * tp, true_sum + pred_sum)
    if average is None:
        return precision, recall, f_score
    weights = true_sum if average == "weighted" else None
    if weights is not None and weights.sum() == 0:
        return 0.0, 0.0, 0.0
    return tuple(float(np.average(x, weights=weights))
                 for x in (precision, recall, f_score))


def _binary_clf_curve(y_true, y_score):
    """Cumulative (fps, tps) at each distinct score, highest first."""
    y_true = np.asarray(y_true).ravel() == 1
    y_score = np.asarray(y_score, np.float64).ravel()
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    ends = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[ends]
    fps = 1 + ends - tps
    return fps, tps


def _binary_roc_auc(y_true, y_score):
    if np.unique(y_true).size != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.")
        return np.nan
    fps, tps = _binary_clf_curve(y_true, y_score)
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(tpr, fpr))


def _binary_average_precision(y_true, y_score):
    """The step sum of precision over recall (sklearn's uninterpolated
    average precision)."""
    fps, tps = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to "
                      "one for all thresholds.")
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _average_binary_score(metric, y_true, y_score, average="macro"):
    """sklearn's ``_average_binary_score``: the metric of a binary target
    as it is; of an indicator matrix per column (averaged ``macro`` or
    ``weighted``) or over the flattened matrix (``micro``)."""
    if average not in _AVERAGES:
        raise ValueError(f"average has to be one of {_AVERAGES}")
    y_true, y_score = np.asarray(y_true), np.asarray(y_score, np.float64)
    kind = _target_type(y_true)
    if kind not in ("binary", "multilabel-indicator"):
        raise ValueError(f"{kind} format is not supported")
    if kind == "binary":
        return metric(y_true, y_score)
    weights = None
    if average == "micro":
        y_true, y_score = y_true.reshape(-1, 1), y_score.reshape(-1, 1)
    elif average == "weighted":
        weights = y_true.sum(0)
        if np.isclose(weights.sum(), 0):
            return 0
    score = np.asarray([metric(y_true[:, c], y_score[:, c])
                        for c in range(y_score.shape[1])])
    if average is None:
        return score
    if weights is not None:
        score[weights == 0] = 0
    return float(np.average(score, weights=weights))


def roc_auc_score(y_true, y_score, average="macro"):
    """sklearn's ``roc_auc_score`` for a binary target or an indicator
    matrix (NaN, with a warning, where a column holds one class)."""
    return _average_binary_score(_binary_roc_auc, y_true, y_score, average)


def average_precision_score(y_true, y_score, average="macro", pos_label=1):
    """sklearn's ``average_precision_score`` for a binary target or an
    indicator matrix."""
    y_true = np.asarray(y_true)
    if _target_type(y_true) == "binary":
        present = np.unique(y_true)
        if present.size == 2 and pos_label not in present:
            raise ValueError(f"pos_label={pos_label} is not a valid label. "
                             f"It should be one of {present.tolist()}")
        y_true = (y_true == pos_label).astype(np.int64)
    return _average_binary_score(_binary_average_precision, y_true, y_score,
                                 average)


class _LabelMetric(BaseMetric):
    """A metric of predicted labels: the argmax of the scores against the
    target class (a soft target's argmax), or, ``multilabel``, the
    rounded sigmoid against the one-hot targets."""

    def __init__(self, name, multilabel=False, **kwargs):
        super().__init__(name)
        self._multilabel = multilabel
        self._kwargs = kwargs

    def _prepare(self, sample_list, model_output):
        scores = _to_np(model_output["scores"])
        expected = _to_np(sample_list["targets"])
        if self._multilabel:
            output = np.round(1.0 / (1.0 + np.exp(-scores)))
            expected = _convert_to_one_hot(expected, scores.shape[-1])
        else:
            output = scores.argmax(axis=-1)
            if expected.ndim != 1:
                expected = expected.argmax(axis=-1)
        return expected, output


@registry.register_metric("f1")
class F1(_LabelMetric):
    def __init__(self, *args, **kwargs):
        multilabel = kwargs.pop("multilabel", False)
        super().__init__("f1", multilabel=multilabel, **kwargs)

    def calculate(self, sample_list, model_output, *args, **kwargs):
        expected, output = self._prepare(sample_list, model_output)
        _, _, f = precision_recall_fscore(expected, output, **self._kwargs)
        return float(np.mean(f))


@registry.register_metric("macro_f1")
class MacroF1(F1):
    def __init__(self, *args, **kwargs):
        super().__init__(average="macro", **kwargs)
        self.name = "macro_f1"


@registry.register_metric("micro_f1")
class MicroF1(F1):
    def __init__(self, *args, **kwargs):
        super().__init__(average="micro", **kwargs)
        self.name = "micro_f1"


@registry.register_metric("binary_f1")
class BinaryF1(F1):
    def __init__(self, *args, **kwargs):
        super().__init__(average="binary", **kwargs)
        self.name = "binary_f1"


@registry.register_metric("multilabel_f1")
class MultiLabelF1(F1):
    def __init__(self, *args, **kwargs):
        super().__init__(multilabel=True, average=None, **kwargs)
        self.name = "multilabel_f1"


@registry.register_metric("multilabel_micro_f1")
class MultiLabelMicroF1(MultiLabelF1):
    def __init__(self, *args, **kwargs):
        kwargs.pop("average", None)
        super().__init__(**kwargs)
        self._kwargs["average"] = "micro"
        self.name = "multilabel_micro_f1"


@registry.register_metric("multilabel_macro_f1")
class MultiLabelMacroF1(MultiLabelF1):
    def __init__(self, *args, **kwargs):
        kwargs.pop("average", None)
        super().__init__(**kwargs)
        self._kwargs["average"] = "macro"
        self.name = "multilabel_macro_f1"


@registry.register_metric("f1_precision_recall")
class F1PrecisionRecall(_LabelMetric):
    """{"precision", "recall", "f1"}, each float32; without an
    ``average``, the means of the per-label values (sklearn's
    ``precision_recall_fscore_support`` averages nothing by default)."""

    def __init__(self, *args, **kwargs):
        multilabel = kwargs.pop("multilabel", False)
        super().__init__("f1_precision_recall", multilabel=multilabel,
                         **kwargs)

    def calculate(self, sample_list, model_output, *args, **kwargs):
        expected, output = self._prepare(sample_list, model_output)
        p, r, f = precision_recall_fscore(expected, output,
                                          **{"average": None,
                                             **self._kwargs})
        return {"precision": np.float32(np.mean(p)),
                "recall": np.float32(np.mean(r)),
                "f1": np.float32(np.mean(f))}


@registry.register_metric("binary_f1_precision_recall")
class BinaryF1PrecisionRecall(F1PrecisionRecall):
    def __init__(self, *args, **kwargs):
        super().__init__(average="binary", **kwargs)
        self.name = "binary_f1_precision_recall"


@registry.register_metric("macro_f1_precision_recall")
class MacroF1PrecisionRecall(F1PrecisionRecall):
    def __init__(self, *args, **kwargs):
        super().__init__(average="macro", **kwargs)
        self.name = "macro_f1_precision_recall"


@registry.register_metric("micro_f1_precision_recall")
class MicroF1PrecisionRecall(F1PrecisionRecall):
    def __init__(self, *args, **kwargs):
        super().__init__(average="micro", **kwargs)
        self.name = "micro_f1_precision_recall"


@registry.register_metric("roc_auc")
class ROC_AUC(BaseMetric):
    """ROC AUC of the softmaxed scores against the one-hot targets,
    averaged over the classes (``average``, macro by default). Needs the
    whole split's report."""

    def __init__(self, *args, **kwargs):
        super().__init__("roc_auc")
        self._kwargs = kwargs

    def calculate(self, sample_list, model_output, *args, **kwargs):
        output = _softmax64(model_output["scores"])
        expected = _convert_to_one_hot(_to_np(sample_list["targets"]),
                                       output.shape[-1])
        return float(roc_auc_score(expected, output, **self._kwargs))


@registry.register_metric("micro_roc_auc")
class MicroROC_AUC(ROC_AUC):
    def __init__(self, *args, **kwargs):
        super().__init__(average="micro", **kwargs)
        self.name = "micro_roc_auc"


@registry.register_metric("macro_roc_auc")
class MacroROC_AUC(ROC_AUC):
    def __init__(self, *args, **kwargs):
        super().__init__(average="macro", **kwargs)
        self.name = "macro_roc_auc"


@registry.register_metric("ap")
class AveragePrecision(BaseMetric):
    """Average precision of the softmaxed scores against the one-hot
    targets (``average``, macro by default)."""

    def __init__(self, *args, **kwargs):
        super().__init__("ap")
        self._kwargs = kwargs

    def calculate(self, sample_list, model_output, *args, **kwargs):
        output = _softmax64(model_output["scores"])
        expected = _convert_to_one_hot(_to_np(sample_list["targets"]),
                                       output.shape[-1])
        return float(average_precision_score(expected, output,
                                             **self._kwargs))


@registry.register_metric("binary_ap")
class BinaryAP(AveragePrecision):
    """Average precision of the positive class's probability."""

    def __init__(self, *args, **kwargs):
        super().__init__(**kwargs)
        self.name = "binary_ap"

    def calculate(self, sample_list, model_output, *args, **kwargs):
        output = _softmax64(model_output["scores"])[:, 1]
        expected = _to_np(sample_list["targets"])
        if expected.ndim == 2:
            expected = expected.argmax(axis=1)
        return float(average_precision_score(expected, output,
                                             **self._kwargs))


@registry.register_metric("micro_ap")
class MicroAP(AveragePrecision):
    def __init__(self, *args, **kwargs):
        super().__init__(average="micro", **kwargs)
        self.name = "micro_ap"


@registry.register_metric("macro_ap")
class MacroAP(AveragePrecision):
    def __init__(self, *args, **kwargs):
        super().__init__(average="macro", **kwargs)
        self.name = "macro_ap"


@registry.register_metric("textvqa_accuracy")
class TextVQAAccuracy(BaseMetric):
    """M4C's greedy-decoded ids (fixed vocabulary, then OCR copies) read
    back into an answer string, up to the first ``</s>``, and scored
    against the ten answers with the TextVQA evaluator (reference
    metrics.py:669). The OCR tokens and the answers arrive as the byte
    arrays the dataset packed (``context_tokens``, ``answers``) and are
    unpacked as the reference does; JAX's metric indexes the packed
    bytes instead (ROADMAP C.8)."""

    def __init__(self):
        super().__init__("textvqa_accuracy")
        from mmf_tpu_torch.utils import m4c_evaluators as evaluators

        self.evaluator = evaluators.TextVQAAccuracyEvaluator()
        self.required_params = ["scores", "answers", "context_tokens"]
        self.gt_key = "answers"

    def calculate(self, sample_list, model_output, *args, **kwargs):
        from mmf_tpu_torch.utils.distributed import byte_tensor_to_object
        from mmf_tpu_torch.utils.text import word_tokenize

        dataset_name = _meta(sample_list, "dataset_name")
        answer_processor = registry.get(dataset_name + "_answer_processor")

        pred_answers = _to_np(model_output["scores"]).argmax(axis=-1)
        context_tokens = sample_list["context_tokens"]
        answers = sample_list[self.gt_key]
        answer_space_size = answer_processor.get_true_vocab_size()

        predictions = []
        for idx in range(len(pred_answers)):
            tokens = byte_tensor_to_object(_to_np(context_tokens[idx]))
            answer_words = []
            for answer_id in pred_answers[idx].tolist():
                answer_id = int(answer_id)
                if answer_id >= answer_space_size:
                    answer_id -= answer_space_size
                    if answer_id < len(tokens):
                        answer_words.append(word_tokenize(tokens[answer_id]))
                else:
                    if answer_id == answer_processor.EOS_IDX:
                        break
                    answer_words.append(
                        answer_processor.answer_vocab.idx2word(answer_id))
            pred_answer = " ".join(answer_words).replace(" 's", "'s")
            predictions.append({
                "pred_answer": pred_answer,
                "gt_answers": byte_tensor_to_object(_to_np(answers[idx]))})
        return float(self.evaluator.eval_pred_list(predictions))


@registry.register_metric("stvqa_anls")
class STVQAANLS(TextVQAAccuracy):
    """``textvqa_accuracy``'s decoded answers scored by ANLS."""

    def __init__(self):
        super().__init__()
        self.name = "stvqa_anls"
        from mmf_tpu_torch.utils import m4c_evaluators as evaluators

        self.evaluator = evaluators.STVQAANLSEvaluator()


@registry.register_metric("stvqa_accuracy")
class STVQAAccuracy(TextVQAAccuracy):
    """``textvqa_accuracy``'s decoded answers scored by exact match."""

    def __init__(self):
        super().__init__()
        self.name = "stvqa_accuracy"
        from mmf_tpu_torch.utils import m4c_evaluators as evaluators

        self.evaluator = evaluators.STVQAAccuracyEvaluator()


@registry.register_metric("ocrvqa_accuracy")
class OCRVQAAccuracy(STVQAAccuracy):
    def __init__(self):
        super().__init__()
        self.name = "ocrvqa_accuracy"


@registry.register_metric("textcaps_bleu4")
class TextCapsBleu4(TextVQAAccuracy):
    """The greedy-decoded captions, read back as ``textvqa_accuracy``
    reads answers, against the reference captions (``ref_strs``) by
    corpus BLEU-4."""

    def __init__(self):
        super().__init__()
        self.name = "textcaps_bleu4"
        self.required_params = ["scores", "ref_strs", "context_tokens"]
        self.gt_key = "ref_strs"
        from mmf_tpu_torch.utils import m4c_evaluators as evaluators

        self.evaluator = evaluators.TextCapsBleu4Evaluator()


@registry.register_metric("caption_bleu4")
class CaptionBleu4Metric(BaseMetric):
    """Corpus BLEU-4 of the decoded captions (``captions``, else the
    scores' argmax) against each image's reference captions
    (``answers``), both decoded to words by the registry's
    ``coco_caption_processor``; nltk's ``corpus_bleu`` with its default
    arguments (``utils/m4c_evaluators.py::corpus_bleu``)."""

    def __init__(self):
        super().__init__("caption_bleu4")
        self.caption_processor = registry.get("coco_caption_processor")
        self.required_params = ["scores", "answers", "captions"]

    def calculate(self, sample_list, model_output, *args, **kwargs):
        from mmf_tpu_torch.utils.m4c_evaluators import corpus_bleu

        references = [
            [self.caption_processor(c)["tokens"]
             for c in np.asarray(_to_np(target)).tolist()]
            for target in _to_np(sample_list["answers"])]
        if "captions" in model_output:
            decoded = _to_np(model_output["captions"])
        else:
            decoded = _to_np(model_output["scores"]).argmax(axis=-1)
        hypotheses = [self.caption_processor(row.tolist())["tokens"]
                      for row in decoded]
        assert len(references) == len(hypotheses)
        return float(corpus_bleu(references, hypotheses))
