"""Losses with the JAX package's registry keys and namespacing.

Port of part of ``mmf_tpu/modules/losses.py``: the containers ``Losses``
and ``MMFLoss`` (the ``<dataset_type>/<dataset_name>/<loss>`` key
contract), ``sigmoid_bce_with_logits``, and the ``logit_bce`` (VQA2),
``cross_entropy`` (nlvr2 head), ``mse``, ``m4c_decoding_bce_with_mask``
(M4C's decode steps) and ``caption_cross_entropy`` (BUTD's) losses. The
other losses are
not ported yet. Every loss is ``loss(sample_list, model_output) ->
scalar | dict`` on tensors, differentiable by autograd.
"""

from __future__ import annotations

import collections.abc
import warnings
from typing import Any, Dict, List, Union

import torch

from mmf_tpu_torch.common.registry import registry


def sigmoid_bce_with_logits(scores, targets):
    """Elementwise binary cross entropy on logits (stable form)."""
    return (torch.clamp(scores, min=0) - scores * targets
            + torch.log1p(torch.exp(-scores.abs())))


class Losses:
    """Instantiates and applies the list of losses of a model config."""

    def __init__(self, loss_list: List[Union[str, Dict[str, Any]]]):
        self.losses = [MMFLoss(loss) for loss in loss_list]
        config = registry.get("config", no_warning=True)
        self._evaluation_predict = False
        if config:
            self._evaluation_predict = (
                config.get("evaluation", {}).get("predict", False)
            )

    def __call__(self, sample_list, model_output) -> Dict[str, torch.Tensor]:
        output: Dict[str, torch.Tensor] = {}
        if "targets" not in sample_list:
            if not self._evaluation_predict:
                warnings.warn(
                    "Sample list has no field 'targets', are you sure that "
                    "your ImDB has labels? you may have wanted to run with "
                    "evaluation.predict=true"
                )
            return output
        for loss in self.losses:
            output.update(loss(sample_list, model_output))
        return output


class MMFLoss:
    """Wraps a loss so its result is a dict keyed
    ``<dataset_type>/<dataset_name>/<loss_name>``."""

    def __init__(self, params=None):
        if params is None:
            params = {}
        is_mapping = isinstance(params, collections.abc.Mapping)
        if is_mapping:
            if "type" not in params:
                raise ValueError(
                    "Parameters to loss must have 'type' field to "
                    "specify type of loss to instantiate"
                )
            loss_name = params["type"]
        elif isinstance(params, str):
            loss_name = params
        else:
            raise TypeError(
                "loss must be a string or dictionary with 'type' key"
            )

        self.name = loss_name
        loss_class = registry.get_loss_class(loss_name)
        if loss_class is None:
            raise ValueError(
                f"No loss named {loss_name} is registered to registry"
            )
        loss_params = params.get("params", {}) if is_mapping else {}
        self.loss_criterion = loss_class(**loss_params)

    def __call__(self, sample_list, model_output) -> Dict[str, torch.Tensor]:
        loss_dict = {}
        datasets = getattr(self.loss_criterion, "datasets", None)
        dataset_name = _get_meta(sample_list, "dataset_name")
        dataset_type = _get_meta(sample_list, "dataset_type")
        if isinstance(datasets, list) and dataset_name not in datasets:
            return loss_dict

        loss_result = self.loss_criterion(sample_list, model_output)
        if not isinstance(loss_result, collections.abc.Mapping):
            loss_result = {"": loss_result}
        for child_name, child_result in loss_result.items():
            key = f"{dataset_type}/{dataset_name}/{self.name}"
            key = f"{key}/{child_name}" if child_name else key
            loss_dict[key] = torch.as_tensor(child_result).float()
        return loss_dict


def _get_meta(sample_list, key):
    try:
        val = sample_list[key]
    except (KeyError, TypeError):
        val = None
    if val is None:
        return {"dataset_name": "unknown", "dataset_type": "train"}[key]
    if isinstance(val, list):
        return val[0]
    return val


@registry.register_loss("logit_bce")
class LogitBinaryCrossEntropy:
    """Mean BCE-with-logits scaled by the number of classes."""

    def __call__(self, sample_list, model_output):
        scores = model_output["scores"]
        targets = sample_list["targets"]
        loss = sigmoid_bce_with_logits(scores, targets).mean()
        return loss * targets.shape[1]


@registry.register_loss("cross_entropy")
class CrossEntropyLoss:
    """Mean negative log-likelihood of integer targets over the entries
    that are not ``ignore_index``."""

    def __init__(self, **params):
        self.ignore_index = params.get("ignore_index", -100)

    def __call__(self, sample_list, model_output):
        scores = model_output["scores"]
        targets = sample_list["targets"].long()
        logprobs = torch.log_softmax(scores, dim=-1)
        valid = targets != self.ignore_index
        safe = torch.where(valid, targets, torch.zeros_like(targets))
        picked = torch.gather(logprobs, -1, safe[..., None])[..., 0]
        picked = torch.where(valid, picked, torch.zeros_like(picked))
        return -picked.sum() / valid.sum().clamp(min=1)


@registry.register_loss("mse")
class MSELoss:
    """Mean squared error between the scores and the targets."""

    def __call__(self, sample_list, model_output):
        diff = model_output["scores"] - sample_list["targets"]
        return torch.mean(diff ** 2)


@registry.register_loss("m4c_decoding_bce_with_mask")
class M4CDecodingBCEWithMaskLoss:
    """BCE over M4C's decode steps, summed over the answer space and the
    steps that ``train_loss_mask`` keeps, over the kept steps' count (at
    least 1) (reference losses.py:575)."""

    def __call__(self, sample_list, model_output):
        scores = model_output["scores"]  # [B, T, V]
        targets = sample_list["targets"]
        loss_mask = sample_list["train_loss_mask"]  # [B, T]
        assert scores.dim() == 3 and loss_mask.dim() == 2
        losses = sigmoid_bce_with_logits(scores, targets)
        losses = losses * loss_mask[..., None]
        count = torch.clamp(loss_mask.sum(), min=1.0)
        return losses.sum() / count


@registry.register_loss("caption_cross_entropy")
class CaptionCrossEntropyLoss:
    """Per-word cross entropy over each caption's decode steps: step t of
    the scores against ``targets[:, t]``, for t < ``caption_len - 1``
    (every step without ``caption_len``), averaged over the steps kept
    (at least 1). Scores longer than the targets are cut to them: BUTD's
    targets, ``text[:, 1:]``, are a step shorter than its scores."""

    def __call__(self, sample_list, model_output):
        targets = sample_list["targets"].long()  # [B, T]
        b, t = targets.shape[:2]
        scores = model_output["scores"][:, :t]
        if "caption_len" in sample_list:
            decode_lengths = sample_list["caption_len"] - 1
        else:
            decode_lengths = torch.full((b,), t, device=targets.device)
        pos = torch.arange(t, device=targets.device)[None, :]
        mask = (pos < decode_lengths[:, None]).float()
        logprobs = torch.log_softmax(scores, dim=-1)
        tok_ll = logprobs.gather(-1, targets[..., None])[..., 0]
        return -(tok_ll * mask).sum() / mask.sum().clamp(min=1.0)
