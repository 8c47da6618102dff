"""MMBT: supervised multimodal bitransformer.

Port of ``mmf_tpu/models/mmbt.py``: modal tokens (the image encoder's
output projected into BERT's token space, with optional start and end
tokens borrowed from the text word-embedding table) are concatenated
before the text tokens, and the whole sequence runs through one BERT
trunk (the shared ``TransformerEncoder``: attention kernel K1, LayerNorm
kernel K4, and the int8 GEMM K5 under ``quant: int8``). Heads:
classification (with ``fused_feature_only``) and ``pretraining`` (masked
LM over the text part of the sequence, labels ``lm_label_ids``).

Input contract (the JAX model's): ``image`` [B, 3, H, W] (encoded by the
modal encoder, ResNet-152 grid features by default) or
``input_modal``/``image_feature_0`` when ``direct_features_input``;
``input_ids``, ``input_mask``, ``segment_ids``. Outputs ``scores``
(float32) and, with ``fused_feature_only``, ``fused_feature`` (the
pooled output); pretraining outputs ``scores`` (the vocabulary logits as
[-1, vocab], compute dtype) and ``losses``.

Module names mirror the flax scopes: ``bert.*`` for the trunk,
``classifier`` (or ``cls``, the masked-LM head), and the image encoder under flax's auto-generated scope
name (``ResNet152ImageEncoder_0``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.encoders import build_image_encoder
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    Embed,
    MLMHead,
    Pooler,
    ResidualLayerNorm,
    TransformerConfig,
    TransformerEncoder,
    apply_padding_idx,
    masked_lm_loss,
)
from mmf_tpu_torch.ops.attention import make_attention_bias


class MMBTTrunk(nn.Module):
    """Shared-embedding multimodal BERT (reference MMBTModel +
    ModalEmbeddings)."""

    def __init__(self, config: TransformerConfig,
                 modal_hidden_size: int = 2048):
        super().__init__()
        self.config = config
        hs, dt = config.hidden_size, config.dtype
        self.word_embeddings = Embed(config.vocab_size, hs, dt)
        self.position_embeddings = Embed(config.max_position_embeddings, hs,
                                         dt)
        self.token_type_embeddings = Embed(config.type_vocab_size, hs, dt)
        self.embeddings_layer_norm = ResidualLayerNorm(hs,
                                                       config.layer_norm_eps)
        self.dropout = Dropout(config.hidden_dropout_prob)
        # a plain Dense under quant: int8 too, as in JAX
        self.proj_embeddings = Dense(modal_hidden_size, hs, dt)
        self.encoder = TransformerEncoder(config)
        self.pooler = Pooler(config)

    def forward(self, modal_tokens, input_ids, input_mask, token_type_ids,
                modal_token_type, modal_start_token=None,
                modal_end_token=None):
        device = input_ids.device
        pieces = []
        if modal_start_token is not None:
            pieces.append(self.word_embeddings(modal_start_token)[:, None])
        pieces.append(self.proj_embeddings(modal_tokens))
        if modal_end_token is not None:
            pieces.append(self.word_embeddings(modal_end_token)[:, None])
        modal = torch.cat(pieces, dim=1)
        b, m_len = modal.shape[:2]
        m_pos = self.position_embeddings(
            torch.arange(m_len, device=device)[None])
        m_type = self.token_type_embeddings(
            modal_token_type.expand(b, m_len))
        modal = self.dropout(self.embeddings_layer_norm(modal + m_pos
                                                        + m_type))

        t_len = input_ids.shape[1]
        text = (
            apply_padding_idx(self.word_embeddings(input_ids), input_ids,
                              self.config.pad_token_id)
            + self.position_embeddings(
                torch.arange(t_len, device=device)[None])
            + self.token_type_embeddings(token_type_ids)
        )
        text = self.dropout(self.embeddings_layer_norm(text))

        x = torch.cat([modal, text], dim=1)
        modal_mask = torch.ones((b, m_len), dtype=input_mask.dtype,
                                device=device)
        bias = make_attention_bias(torch.cat([modal_mask, input_mask], dim=1),
                                   self.config.dtype)
        seq = self.encoder(x, bias=bias)
        return seq, self.pooler(seq), m_len


@registry.register_model("mmbt")
class MMBT(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        cfg = self._tcfg()
        self.head = self.config.get("training_head_type", "classification")
        self.direct = self.config.get("direct_features_input", False)
        self.encoder_name = None
        if not self.direct:
            encoder = build_image_encoder(self.config.get(
                "modal_encoder", {"type": "resnet152", "params": {}}))
            # flax's auto-generated scope of the unnamed encoder module
            self.encoder_name = f"{type(encoder).__name__}_0"
            self.add_module(self.encoder_name, encoder)
        self.bert = MMBTTrunk(cfg, self.config.get("modal_hidden_size", 2048))
        if self.head == "pretraining":
            self.cls = MLMHead(cfg)
            return
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.num_labels = self.config.get("num_labels", 2)
        self.classifier = Dense(cfg.hidden_size, self.num_labels, cfg.dtype)

    @classmethod
    def config_path(cls):
        return "configs/models/mmbt/pretrain.yaml"

    def get_weight_decay_mask(self, config=None):
        """Bias and LayerNorm parameters are exempt from weight decay
        (``bert_no_decay_mask``), as in the JAX model."""
        from mmf_tpu_torch.utils.modeling import bert_no_decay_mask

        return bert_no_decay_mask()

    def _text_params(self) -> Dict[str, Any]:
        return (self.config.get("text_encoder", {}) or {}).get(
            "params", {}) or {}

    def _tcfg(self) -> TransformerConfig:
        text = self._text_params()
        hidden = text.get("hidden_size", 768)
        return TransformerConfig.from_dict({
            "hidden_size": hidden,
            "num_hidden_layers": text.get("num_hidden_layers", 12),
            "num_attention_heads": text.get("num_attention_heads", 12),
            "intermediate_size": text.get("intermediate_size", hidden * 4),
            "vocab_size": text.get("vocab_size", 30522),
            "type_vocab_size": text.get("num_segments", 2),
            "dtype": self.config.get("dtype", "float32"),
            "quant": self.config.get("quant", "none"),
        })

    @staticmethod
    def _modal_token_type(segment_ids: torch.Tensor,
                          num_max_segment: int) -> torch.Tensor:
        """The type id the text does NOT use (reference mmbt.py:395-418),
        [1, 1] on the device: computed with ``torch.where``, never read
        back to the host."""
        max_id, min_id = segment_ids.max(), segment_ids.min()
        one, zero = torch.ones_like(max_id), torch.zeros_like(max_id)
        last = torch.full_like(max_id, num_max_segment - 1)
        token = torch.where(
            max_id == min_id,
            torch.where(max_id == 0, one, zero),
            torch.where(max_id != num_max_segment - 1, last, zero),
        )
        return token.reshape(1, 1)

    def forward(self, sample_list: Dict[str, Any]):
        if self.direct:
            modal_tokens = sample_list.get(
                "input_modal", sample_list.get("image_feature_0"))
        else:
            modal_tokens = getattr(self, self.encoder_name)(
                sample_list["image"])
        if modal_tokens.dim() == 2:
            modal_tokens = modal_tokens[:, None, :]

        input_ids = sample_list["input_ids"].long()
        input_mask = sample_list["input_mask"]
        segment_ids = sample_list["segment_ids"].long()

        start = end = None
        if self.config.get("use_modal_start_token", True):
            start = input_ids[:, 0]
        if self.config.get("use_modal_end_token", True):
            # the last unmasked token (<sep>); then the text shifts left
            last = input_mask.sum(dim=1).long() - 1
            end = torch.gather(input_ids, 1, last[:, None])[:, 0]
            input_ids = torch.cat([input_ids[:, 1:], input_ids[:, -1:]], 1)
            input_mask = torch.cat(
                [input_mask[:, 1:], torch.zeros_like(input_mask[:, -1:])], 1)
            segment_ids = torch.cat([segment_ids[:, 1:], segment_ids[:, -1:]],
                                    1)

        modal_type = self._modal_token_type(
            segment_ids, self._text_params().get("num_segments", 2))
        seq, pooled, m_len = self.bert(modal_tokens, input_ids, input_mask,
                                       segment_ids, modal_type, start, end)
        if self.head == "pretraining":
            logits = self.cls(seq[:, m_len:])
            loss = masked_lm_loss(logits, sample_list["lm_label_ids"])
            name = sample_list.get("dataset_name", "unknown")
            split = sample_list.get("dataset_type", "train")
            return {"scores": logits.reshape(-1, logits.shape[-1]),
                    "losses": {f"{split}/{name}/masked_lm_loss": loss}}

        output: Dict[str, Any] = {}
        if self.config.get("fused_feature_only", False):
            output["fused_feature"] = pooled
        logits = self.classifier(self.dropout(pooled))
        output["scores"] = logits.reshape(-1, self.num_labels).float()
        return output
