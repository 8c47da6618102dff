"""VinVL (Oscar+): a single-stream encoder over the caption, the object
tags and the regions.

Port of ``mmf_tpu/models/vinvl.py``. The text (the caption and its tags
as one BERT pair, ``vinvl_text_tokenizer``'s) and the projected regions
(a float32 Dense as wide as the data's features, sized by
``materialize`` or a state dict, then a LayerNorm with
``use_img_layernorm``, then dropout) run through one BERT trunk; its
first token is pooled. One trunk, whose modules run once a forward, or
twice in pretraining when the batch has a corrupted pair.

Heads: ``classification`` (the default): ``mlp_num_layers`` x (dropout,
``PredictionHeadTransform``), then a float32 Dense to ``num_labels``;
with ``labels`` in the batch, its cross entropy as ``ce``.
``pretraining``: the masked LM over the text positions of the masked
ids (``input_ids_masked``), and, with ``contrastive_labels``, the
three-way classifier on the pooled output of a second pass over
``input_ids_corrupt`` (the first pass's when the batch has no corrupted
pair). Losses are named ``{dataset_type}/{dataset_name}/{loss}``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    LazyDense,
    MLMHead,
    Pooler,
    PredictionHeadTransform,
    ResidualLayerNorm,
    TextEmbeddings,
    TransformerConfig,
    TransformerEncoder,
    masked_lm_loss,
    picked_log_prob,
)
from mmf_tpu_torch.ops.attention import make_attention_bias


@registry.register_model("vinvl")
class VinVL(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        cfg = self._tcfg()
        self.head = c.get("training_head_type", "classification")
        hs = cfg.hidden_size
        self.embeddings = TextEmbeddings(cfg)
        self.img_projection = LazyDense(hs)
        self.use_img_layernorm = bool(c.get("use_img_layernorm", True))
        if self.use_img_layernorm:
            self.img_layer_norm = ResidualLayerNorm(
                hs, c.get("img_layer_norm_eps", 1e-12))
        self.img_dropout = Dropout(cfg.hidden_dropout_prob)
        self.encoder = TransformerEncoder(cfg)
        self.pooler = Pooler(cfg)
        if self.head == "pretraining":
            self.cls = MLMHead(cfg)
            self.three_way_classifier = Dense(hs, 3)
            return
        self.num_labels = c.get("num_labels", 3129)
        self.mlp_num_layers = int(c.get("mlp_num_layers", 0))
        self.classifier_dropout = Dropout(cfg.hidden_dropout_prob)
        for i in range(self.mlp_num_layers):
            self.add_module(f"classifier_transform_{i}",
                            PredictionHeadTransform(cfg))
        self.classifier_logits = Dense(hs, self.num_labels)

    @classmethod
    def config_path(cls):
        return "configs/models/vinvl/defaults.yaml"

    def _tcfg(self) -> TransformerConfig:
        c = self.config
        return TransformerConfig.from_dict({
            "hidden_size": c.get("hidden_size", 768),
            "num_hidden_layers": c.get("num_hidden_layers", 12),
            "num_attention_heads": c.get("num_attention_heads", 12),
            "intermediate_size": c.get("intermediate_size", 3072),
            "vocab_size": c.get("vocab_size", 30522),
            "max_position_embeddings": c.get("max_position_embeddings", 512),
            "type_vocab_size": c.get("type_vocab_size", 2),
            "hidden_dropout_prob": c.get("hidden_dropout_prob", 0.1),
            "attention_probs_dropout_prob": c.get(
                "attention_probs_dropout_prob", 0.1),
            "layer_norm_eps": c.get("layer_norm_eps", 1e-12),
            "dtype": c.get("dtype", "float32"),
            "quant": c.get("quant", "none"),
        })

    def materialize(self, sample_list: Dict[str, Any]) -> "VinVL":
        """Size the region projection by the batch's feature width."""
        self.img_projection.materialize(
            sample_list["image_feature_0"].shape[-1])
        return self

    def _trunk(self, ids, segments, txt_mask, img_feats, image_mask):
        text = self.embeddings(ids, segments)
        img = self.img_projection(img_feats)
        if self.use_img_layernorm:
            img = self.img_layer_norm(img)
        x = torch.cat([text, self.img_dropout(img)], dim=1)
        mask = torch.cat([txt_mask, image_mask], dim=1)
        seq = self.encoder(x, bias=make_attention_bias(mask,
                                                       self._tcfg().dtype))
        return seq, self.pooler(seq)

    def forward(self, sample_list: Dict[str, Any]):
        img_feats = sample_list["image_feature_0"]
        input_mask = sample_list["input_mask"]
        pretraining = self.head == "pretraining"
        input_ids = sample_list[
            "input_ids_masked"
            if pretraining and "input_ids_masked" in sample_list
            else "input_ids"]
        segment_ids = sample_list.get("segment_ids")
        if segment_ids is None:
            segment_ids = torch.zeros_like(input_ids)
        image_mask = sample_list.get("image_mask")
        if image_mask is None:
            image_mask = torch.ones(img_feats.shape[:2],
                                    dtype=input_mask.dtype,
                                    device=img_feats.device)
        seq, pooled = self._trunk(input_ids, segment_ids, input_mask,
                                  img_feats, image_mask)
        name = sample_list.get("dataset_name", "unknown")
        split = sample_list.get("dataset_type", "train")

        if pretraining:
            losses = {}
            logits = self.cls(seq[:, : input_ids.shape[1]])
            labels = sample_list.get("lm_label_ids")
            if labels is not None:
                losses[f"{split}/{name}/masked_lm_loss"] = masked_lm_loss(
                    logits, labels)
            if "contrastive_labels" in sample_list:
                pooled_c = pooled
                if "input_ids_corrupt" in sample_list:
                    _, pooled_c = self._trunk(
                        sample_list["input_ids_corrupt"],
                        sample_list.get("segment_ids_corrupt", segment_ids),
                        sample_list.get("input_mask_corrupt", input_mask),
                        img_feats, image_mask)
                three_way = self.three_way_classifier(pooled_c)
                losses[f"{split}/{name}/three_way_contrastive_loss"] = (
                    -picked_log_prob(three_way,
                                     sample_list["contrastive_labels"]
                                     ).mean())
            return {"scores": logits.reshape(-1, logits.shape[-1]),
                    "losses": losses}

        x = pooled
        for i in range(self.mlp_num_layers):
            x = getattr(self, f"classifier_transform_{i}")(
                self.classifier_dropout(x))
        logits = self.classifier_logits(x)
        output = {"scores": logits.reshape(-1, self.num_labels).float()}
        if "labels" in sample_list:
            output["losses"] = {f"{split}/{name}/ce": -picked_log_prob(
                logits, sample_list["labels"]).mean()}
        return output
