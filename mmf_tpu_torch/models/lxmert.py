"""LXMERT: language, relational and cross-modality layer stacks.

Port of ``mmf_tpu/models/lxmert.py``. The question (BERT's embeddings)
runs through ``l_layers`` transformer layers (9), the regions (the
feature and the 4-wide box, each projected and normalised, averaged)
through ``r_layers`` (5), then both through ``x_layers`` cross layers
(5). A cross layer's one ``visual_attention`` module attends both ways,
text queries over the regions and region queries over the text, each
call masked by its keys' padding; then each stream's self-attention
and feed-forward. The text's first token is pooled.

Heads: ``pretraining`` (``training_head_type``, the YAML's default):
the masked LM over the text (``masked_lm_loss``, scores [B·T, vocab]),
the matched score against ``is_correct`` (``matched_loss``; a label of
-1 picks the last class, as JAX's ``take_along_axis`` does) and the
features regressed at the regions labelled 1 (``feat_loss``), each by
its ``task_*`` flag and only when the batch has its labels; any other
type classifies the pooled text into ``num_labels`` (``gqa_labels`` for
``gqa``). The heads' plain layers compute in float32, as flax's
``nn.Dense`` without a dtype does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    FeedForward,
    MLMHead,
    Pooler,
    PredictionHeadTransform,
    ResidualLayerNorm,
    SelfAttention,
    TextEmbeddings,
    TransformerConfig,
    TransformerLayer,
    attend,
    masked_lm_loss,
    picked_log_prob,
)
from mmf_tpu_torch.ops.attention import make_attention_bias


def _split(x, h):
    b, s, d = x.shape
    return x.view(b, s, h, d // h).transpose(1, 2)


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class CrossAttLayer(nn.Module):
    """Attention of ``input_tensor`` over ``ctx_tensor``, its output
    projection, dropout and the residual LayerNorm."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        hs, dt = config.hidden_size, config.dtype
        self.query = Dense(hs, hs, dt)
        self.key = Dense(hs, hs, dt)
        self.value = Dense(hs, hs, dt)
        self.output_dense = Dense(hs, hs, dt)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.output_ln = ResidualLayerNorm(hs, config.layer_norm_eps)

    def forward(self, input_tensor, ctx_tensor, ctx_bias=None):
        c = self.config
        h = c.num_attention_heads
        ctx = attend(_split(self.query(input_tensor), h),
                     _split(self.key(ctx_tensor), h),
                     _split(self.value(ctx_tensor), h), ctx_bias,
                     c.attention_probs_dropout_prob, self.training)
        out = self.dropout(self.output_dense(_merge(ctx)))
        return self.output_ln(out, input_tensor)


class LXMERTXLayer(nn.Module):
    """The cross layer: one shared cross-attention module, both ways,
    then each stream's self-attention and feed-forward."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.visual_attention = CrossAttLayer(config)
        self.lang_self_att = SelfAttention(config)
        self.visn_self_att = SelfAttention(config)
        self.lang_ffn = FeedForward(config)
        self.visn_ffn = FeedForward(config)

    def forward(self, lang, lang_bias, visn, visn_bias):
        lang_att = self.visual_attention(lang, visn, visn_bias)
        visn_att = self.visual_attention(visn, lang, lang_bias)
        lang_att = self.lang_self_att(lang_att, bias=lang_bias)
        visn_att = self.visn_self_att(visn_att, bias=visn_bias)
        return self.lang_ffn(lang_att), self.visn_ffn(visn_att)


class VisualFeatEncoder(nn.Module):
    """Region features and boxes, each projected and normalised, then
    averaged."""

    def __init__(self, config: TransformerConfig, visual_feat_dim: int,
                 visual_pos_dim: int):
        super().__init__()
        hs, dt, eps = config.hidden_size, config.dtype, config.layer_norm_eps
        self.visn_fc = Dense(visual_feat_dim, hs, dt)
        self.visn_ln = ResidualLayerNorm(hs, eps)
        self.box_fc = Dense(visual_pos_dim, hs, dt)
        self.box_ln = ResidualLayerNorm(hs, eps)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, feats, boxes):
        x = self.visn_ln(self.visn_fc(feats))
        y = self.box_ln(self.box_fc(boxes))
        return self.dropout((x + y) / 2)


@registry.register_model("lxmert")
class LXMERT(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        cfg = self._tcfg()
        self.head = c.get("training_head_type", "pretraining")
        self.embeddings = TextEmbeddings(cfg)
        self.visn_fc = VisualFeatEncoder(cfg, c.get("visual_feat_dim", 2048),
                                         c.get("visual_pos_dim", 4))
        for i in range(c.get("l_layers", 9)):
            self.add_module(f"l_layer_{i}", TransformerLayer(cfg))
        for i in range(c.get("r_layers", 5)):
            self.add_module(f"r_layer_{i}", TransformerLayer(cfg))
        for i in range(c.get("x_layers", 5)):
            self.add_module(f"x_layer_{i}", LXMERTXLayer(cfg))
        self.pooler = Pooler(cfg)
        hs = cfg.hidden_size
        if self.head == "pretraining":
            if c.get("task_mask_lm", True):
                self.cls = MLMHead(cfg)
            if c.get("task_matched", True):
                self.seq_relationship = Dense(hs, 2)
            if c.get("task_obj_predict", True):
                self.obj_transform = PredictionHeadTransform(cfg)
                self.feat_decoder = Dense(hs, c.get("visual_feat_dim", 2048))
            return
        self.num_labels = c.get(
            "gqa_labels" if self.head == "gqa" else "num_labels", 3129)
        self.classifier_transform = PredictionHeadTransform(cfg)
        self.classifier_logits = Dense(hs, self.num_labels)

    @classmethod
    def config_path(cls):
        return "configs/models/lxmert/defaults.yaml"

    def get_weight_decay_mask(self, config=None):
        """Bias and LayerNorm parameters are exempt from weight decay
        (``bert_no_decay_mask``), as in the JAX model."""
        from mmf_tpu_torch.utils.modeling import bert_no_decay_mask

        return bert_no_decay_mask()

    def _tcfg(self) -> TransformerConfig:
        c = self.config
        return TransformerConfig.from_dict({
            "hidden_size": c.get("hidden_size", 768),
            "num_attention_heads": c.get("num_attention_heads", 12),
            "intermediate_size": c.get("intermediate_size", 3072),
            "vocab_size": c.get("vocab_size", 30522),
            "hidden_dropout_prob": c.get("hidden_dropout_prob", 0.1),
            "layer_norm_eps": c.get("layer_norm_eps", 1e-12),
            "dtype": c.get("dtype", "float32"),
        })

    def forward(self, sample_list: Dict[str, Any]):
        c = self.config
        dt = self._tcfg().dtype
        input_ids = sample_list["input_ids"]
        input_mask = sample_list["input_mask"]
        segment_ids = sample_list.get("segment_ids")
        if segment_ids is None:
            segment_ids = torch.zeros_like(input_ids)
        visual_feats = sample_list["image_feature_0"]
        info = sample_list.get("image_info_0") or {}
        visual_pos = info.get("bbox") if hasattr(info, "get") else None
        if visual_pos is None:
            visual_pos = torch.zeros(visual_feats.shape[:2] + (4,),
                                     device=visual_feats.device)
        visual_pos = visual_pos[:, :, :4]
        image_mask = sample_list.get("image_mask")
        if image_mask is None:
            image_mask = torch.ones(visual_feats.shape[:2],
                                    dtype=input_mask.dtype,
                                    device=visual_feats.device)
        lang_bias = make_attention_bias(input_mask, dt)
        visn_bias = make_attention_bias(image_mask, dt)

        lang = self.embeddings(input_ids, segment_ids)
        visn = self.visn_fc(visual_feats, visual_pos)
        for i in range(c.get("l_layers", 9)):
            lang = getattr(self, f"l_layer_{i}")(lang, bias=lang_bias)
        for i in range(c.get("r_layers", 5)):
            visn = getattr(self, f"r_layer_{i}")(visn, bias=visn_bias)
        for i in range(c.get("x_layers", 5)):
            lang, visn = getattr(self, f"x_layer_{i}")(lang, lang_bias,
                                                       visn, visn_bias)
        pooled = self.pooler(lang)
        name = sample_list.get("dataset_name", "unknown")
        split = sample_list.get("dataset_type", "train")

        if self.head != "pretraining":
            logits = self.classifier_logits(self.classifier_transform(pooled))
            return {"scores": logits.reshape(-1, self.num_labels).float()}

        output: Dict[str, Any] = {}
        losses = {}
        if c.get("task_mask_lm", True):
            logits = self.cls(lang)
            labels = sample_list.get("lm_label_ids")
            if labels is not None:
                losses[f"{split}/{name}/masked_lm_loss"] = masked_lm_loss(
                    logits, labels)
            output["scores"] = logits.reshape(-1, logits.shape[-1])
        if c.get("task_matched", True) and "is_correct" in sample_list:
            seq_rel = self.seq_relationship(pooled)
            losses[f"{split}/{name}/matched_loss"] = -picked_log_prob(
                seq_rel, sample_list["is_correct"]).mean()
        if c.get("task_obj_predict", True) and "image_labels" in sample_list:
            feat_pred = self.feat_decoder(self.obj_transform(visn))
            mask = (sample_list["image_labels"] == 1).float()
            se = ((feat_pred - visual_feats) ** 2).sum(-1)
            losses[f"{split}/{name}/feat_loss"] = (se * mask).sum() / (
                mask.sum().clamp(min=1.0))
        if losses:
            output["losses"] = losses
        return output
