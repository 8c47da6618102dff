"""The registered transformer heads.

Port of ``mmf_tpu/models/transformers/heads/heads.py``: ``mlm``,
``mlm_multi``, ``mlp`` (and ``multilayer_mlp``), ``itm``, ``mrc``,
``mrfr``, ``wra``, ``contrastive`` (and ``contrastive_three_way``),
``refiner`` and ``refiner_classifier`` (and ``refnet_classifier``).

Every head takes ``(sequence_output, processed_sample_list)`` and returns
``{"scores": ...}`` and/or ``{"losses": {name: scalar}}``. The heads'
layers carry no dtype in JAX, so flax computes them in float32 whatever
the trunk's dtype: here they are ``Dense`` layers of compute dtype
float32. Losses over masked positions are fixed-shape masked means that
give 0 where no label is valid (``_masked_ce``). flax takes the output
width of ``mrc``'s and ``mrfr``'s decoders from their targets: here they
are sized by ``materialize(sample_list)``, by the first forward or by a
state dict.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.transformers.base import BaseTransformerHead
from mmf_tpu_torch.modules.transformer import (
    ACT2FN,
    Dense,
    Dropout,
    MLMHead,
    Pooler,
    PredictionHeadTransform,
    ResidualLayerNorm,
    TransformerConfig,
)

_HEAD_CONFIG_KEYS = ("hidden_size", "vocab_size", "hidden_dropout_prob",
                     "layer_norm_eps", "hidden_act")


def _cfg_from(config, **defaults) -> TransformerConfig:
    d = dict(defaults)
    d.update({k: v for k, v in (config or {}).items()
              if k in _HEAD_CONFIG_KEYS})
    return TransformerConfig.from_dict(d)


def _masked_ce(logits, labels, ignore_index=-1):
    """Cross entropy over the positions whose label is not
    ``ignore_index``, a float32 log-softmax; 0 where there is none."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    picked = logprobs.gather(-1, safe[..., None])[..., 0]
    total = torch.where(valid, picked, torch.zeros_like(picked)).sum()
    return -total / valid.sum().clamp(min=1)


class _TargetSizedDense(nn.modules.lazy.LazyModuleMixin, Dense):
    """A float32 ``Dense`` whose output width is its targets' last
    dimension, as flax's ``nn.Dense(targets.shape[-1])`` takes it: sized
    by ``materialize(width)`` or by ``load_state_dict``; the first forward
    that finds it sized makes it a ``Dense``."""

    cls_to_become = Dense

    def __init__(self, in_features: int):
        super().__init__(in_features, 0, torch.float32)
        self.weight = nn.UninitializedParameter()
        self.bias = nn.UninitializedParameter()

    def initialize_parameters(self, x):
        if self.has_uninitialized_params():
            raise RuntimeError("size the decoder with materialize(width) "
                               "before its first forward")

    @torch.no_grad()
    def materialize(self, out_features: int):
        if self.has_uninitialized_params():
            self.out_features = int(out_features)
            self.weight.materialize((self.out_features, self.in_features))
            self.bias.materialize((self.out_features,))
            self.reset_parameters()


def _materialize(dense, width):
    if isinstance(dense, _TargetSizedDense):
        dense.materialize(width)


@registry.register_transformer_head("mlm")
class MLM(BaseTransformerHead):
    """(reference heads/mlm.py) The masked-LM head. ``tie_embeddings()``
    makes its decoder the caller's token table (``shared_embedding``),
    as ``mmf_transformer`` ties it; untied it owns a ``decoder``."""

    ties_embeddings = True

    def __init__(self, config: Any = None):
        super().__init__(config)
        self.cls = MLMHead(_cfg_from(self.config))

    def tie_embeddings(self):
        self.cls = MLMHead(_cfg_from(self.config), tied=True)

    def forward(self, sequence_output, processed_sample_list=None,
                shared_embedding=None):
        c, sl = self.config, processed_sample_list
        label_key = c.get("label_key", None)
        if label_key is not None:
            labels = sl[label_key]
        else:
            labels = sl["mlm_labels"]["combined_labels"]
        # hidden states encoded from the masked ids (ViLT's second pass)
        # are what the loss scores, where the model gives them
        sequence_output = sl.get("hs_masked_for_mlm", sequence_output)
        logits = self.cls(sequence_output, shared_embedding=shared_embedding)
        loss = _masked_ce(logits, labels, c.get("ignore_index", -1))
        return {"logits": logits,
                "losses": {c.get("loss_name", "masked_lm_loss"): loss}}


@registry.register_transformer_head("mlm_multi")
class MLMForMultiHeads(BaseTransformerHead):
    """The MLM head over the masked pass's hidden states."""

    ties_embeddings = True

    def __init__(self, config: Any = None):
        super().__init__(config)
        self.mlm_head = MLM(self.config)

    def tie_embeddings(self):
        self.mlm_head.tie_embeddings()

    def forward(self, _, processed_sample_list=None, shared_embedding=None):
        return self.mlm_head(processed_sample_list["hs_masked_for_mlm"],
                             processed_sample_list=processed_sample_list,
                             shared_embedding=shared_embedding)


@registry.register_transformer_head("multilayer_mlp")
@registry.register_transformer_head("mlp")
class MLPHead(BaseTransformerHead):
    """(reference heads/mlp.py) The pooler (``bert_pooler`` or
    ``identity``), then ``num_layers`` x (dropout, dense, the exact-erf
    GELU in float32, LayerNorm eps 1e-6), then the decoder."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        self.num_labels = c.get("num_labels", 2)
        hidden = c.get("hidden_size", 768)
        self.in_dim = c.get("in_dim") or hidden
        self.num_layers = c.get("num_layers", 1)
        self.pooler_name = c.get("pooler_name", "bert_pooler")
        if self.pooler_name == "bert_pooler":
            self.pooler = Pooler(TransformerConfig.from_dict(
                {"hidden_size": self.in_dim}))
        elif self.pooler_name != "identity":
            raise NotImplementedError(
                f"{self.pooler_name} is not implemented.")
        self.dropout = Dropout(c.get("hidden_dropout_prob", 0.1))
        for i in range(self.num_layers):
            self.add_module(f"transform_dense_{i}", Dense(
                self.in_dim if i == 0 else hidden, hidden))
            self.add_module(f"transform_ln_{i}", ResidualLayerNorm(
                hidden, c.get("layer_norm_eps", 1e-6)))
        self.decoder = Dense(hidden, self.num_labels)

    def forward(self, sequence_output, processed_sample_list=None):
        if sequence_output.shape[-1] != self.in_dim:
            raise ValueError("Mismatch between MLP head in_dim and "
                             "sequence_output last dim")
        x = sequence_output
        if self.pooler_name == "bert_pooler":
            x = self.pooler(sequence_output)
        act = ACT2FN[self.config.get("hidden_act", "gelu")]
        for i in range(self.num_layers):
            x = getattr(self, f"transform_dense_{i}")(self.dropout(x))
            x = getattr(self, f"transform_ln_{i}")(act(x))
        logits = self.decoder(x)
        return {"scores": logits.reshape(-1, self.num_labels)}


@registry.register_transformer_head("itm")
class ITM(BaseTransformerHead):
    """(reference heads/itm.py) Image-text matching: pooler, a 2-way
    classifier, cross entropy against ``is_correct``."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        tcfg = _cfg_from(self.config)
        self.pooler = Pooler(tcfg)
        self.seq_relationship = Dense(tcfg.hidden_size, 2)

    def forward(self, sequence_output, processed_sample_list=None):
        c, sl = self.config, processed_sample_list
        label_key = c.get("itm_label_key", "is_correct")
        labels = sl[label_key] if label_key in sl else \
            sl["itm_labels"][label_key]
        logits = self.seq_relationship(self.pooler(sequence_output))
        loss = _masked_ce(logits.reshape(-1, 2), labels.reshape(-1),
                          c.get("ignore_index", -1))
        return {"losses": {c.get("loss_name", "itm_loss"): loss}}


class _RegionHead(BaseTransformerHead):
    """A transform and a decoder over the last R positions (the image
    regions), R and the decoder's width from ``<label_key>["targets"]``."""

    label_key = ""

    def __init__(self, config: Any = None):
        super().__init__(config)
        tcfg = _cfg_from(self.config)
        self.transform = PredictionHeadTransform(tcfg)
        self.decoder = _TargetSizedDense(tcfg.hidden_size)

    def materialize(self, sample_list):
        labels = sample_list.get(self.label_key)
        if labels is not None:
            _materialize(self.decoder, labels["targets"].shape[-1])

    def _decode(self, sequence_output, targets):
        _materialize(self.decoder, targets.shape[-1])
        return self.decoder(self.transform(
            sequence_output[:, -targets.shape[1]:]))


@registry.register_transformer_head("mrc")
class MRC(_RegionHead):
    """(reference heads/mrc.py) Masked region classification: the KL
    divergence from the detector's class probabilities over the masked
    regions."""

    label_key = "mrc_labels"

    def forward(self, sequence_output, processed_sample_list=None):
        labels = processed_sample_list[self.label_key]
        targets, is_masked = labels["targets"], labels["is_masked"]
        logprobs = torch.log_softmax(
            self._decode(sequence_output, targets).float(), dim=-1)
        tgt = targets.float()
        zero = tgt == 0
        kld = torch.where(zero, torch.zeros_like(tgt), tgt * (torch.log(
            torch.where(zero, torch.ones_like(tgt), tgt)) - logprobs)
        ).sum(-1)
        mask = is_masked.float()
        loss = (kld * mask).sum() / mask.sum().clamp(min=1.0)
        return {"losses": {self.config.get("loss_name", "mrc_loss"): loss}}


@registry.register_transformer_head("mrfr")
class MRFR(_RegionHead):
    """(reference heads/mrfr.py) Masked region feature regression: the
    squared error to the original features over the masked regions. As
    in JAX, the decoder is the head's own (the reference ties it to the
    image embedding's weight)."""

    label_key = "mrfr_labels"

    def forward(self, sequence_output, processed_sample_list=None):
        labels = processed_sample_list[self.label_key]
        targets, is_masked = labels["targets"], labels["is_masked"]
        pred = self._decode(sequence_output, targets)
        se = ((pred - targets) ** 2).sum(-1)
        mask = is_masked.float()
        loss = (se * mask).sum() / mask.sum().clamp(min=1.0)
        return {"losses": {self.config.get("loss_name", "mrfr_loss"): loss}}


@registry.register_transformer_head("wra")
class WRA(BaseTransformerHead):
    """(reference heads/wra.py) Word-region alignment: the optimal
    transport distance between the text and the image positions, signed
    by ``is_correct``."""

    def forward(self, sequence_output, processed_sample_list=None):
        from mmf_tpu_torch.modules.ot import optimal_transport_dist

        info = processed_sample_list["wra_info"]
        txt_pad = info["txt_pad"].bool()
        img_pad = info["img_pad"].bool()
        is_correct = info["is_correct"]
        t = txt_pad.shape[1]
        dist = optimal_transport_dist(
            sequence_output[:, :t], sequence_output[:, t:t + img_pad.shape[1]],
            txt_pad, img_pad)
        sign = is_correct if is_correct.dtype == torch.float32 else \
            is_correct.float() * 2 - 1
        loss = (dist * sign).mean()
        return {"losses": {self.config.get("loss_name", "wra_loss"): loss}}


@registry.register_transformer_head("contrastive_three_way")
@registry.register_transformer_head("contrastive")
class ContrastiveHead(BaseTransformerHead):
    """(reference heads/contrastive.py) Pooler and a ``num_labels``-way
    classifier against ``contrastive_labels``."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        tcfg = _cfg_from(self.config)
        self.pooler = Pooler(tcfg)
        self.decoder = Dense(tcfg.hidden_size,
                             self.config.get("num_labels", 3))

    def forward(self, sequence_output, processed_sample_list=None):
        c = self.config
        logits = self.decoder(self.pooler(sequence_output))
        loss = _masked_ce(logits, processed_sample_list["contrastive_labels"],
                          c.get("ignore_index", -1))
        return {"losses": {
            c.get("loss_name", "three_way_contrastive_loss"): loss}}


@registry.register_transformer_head("refiner")
class Refiner(BaseTransformerHead):
    """(reference heads/refiner.py) The fused embedding (pooler and a
    dense) decoded back towards each modality's masked mean over its span
    of the sequence (the spans from ``masks``, in modality order; the
    whole sequence's mean without them)."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        hidden = self.config.get("hidden_size", 768)
        self.pooler = Pooler(_cfg_from(self.config, hidden_size=hidden))
        self.fusion = Dense(hidden, hidden)
        self.modalities = list(self.config.get("modalities",
                                               ["text", "image"]))
        for m in self.modalities:
            self.add_module(f"decoder_{m}", Dense(hidden, hidden))

    def forward(self, sequence_output, processed_sample_list=None):
        fused = self.fusion(self.pooler(sequence_output))
        masks = None
        if processed_sample_list is not None:
            masks = processed_sample_list.get("masks", None)
        losses, start = {}, 0
        for m in self.modalities:
            dec = getattr(self, f"decoder_{m}")(fused)
            if masks is not None and m in masks:
                mask = masks[m].to(sequence_output.dtype)
                span = sequence_output[:, start:start + mask.shape[1]]
                denom = mask.sum(1, keepdim=True).clamp(min=1.0)
                target = (span * mask[..., None]).sum(1) / denom
                start += mask.shape[1]
            else:
                target = sequence_output.mean(1)
            losses[f"refiner_{m}_loss"] = ((dec - target) ** 2).mean()
        return {"fused_embedding": fused, "losses": losses}


@registry.register_transformer_head("refiner_classifier")
@registry.register_transformer_head("refnet_classifier")
class RefinerClassifier(BaseTransformerHead):
    """(reference heads/refnet_classifier.py) A refiner and an MLP head
    side by side: the MLP's scores, the refiner's fused embedding and
    losses."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        self.refiner = Refiner(c.get("refiner_config", c))
        self.mlp = MLPHead(c.get("mlp_config", c))

    def forward(self, sequence_output, processed_sample_list=None):
        refined = self.refiner(sequence_output, processed_sample_list)
        mlp_out = self.mlp(sequence_output, processed_sample_list)
        return {"scores": mlp_out["scores"],
                "fused_embedding": refined["fused_embedding"],
                "losses": refined.get("losses", {})}

