"""Top-down attention over region features: the part of
``mmf_tpu/modules/attention.py`` that the Pythia family uses.

``TopDownAttention`` combines the regions with the question embedding
(``ModalCombineLayer``), maps each region to one raw score
(``TransformLayer``) and normalises over the regions: a softmax whose
regions past ``image_locs`` are zeroed and the rest renormalised
(``s + (s == 0) + 1e-8``), or a sigmoid, masked. ``AttentionLayer`` is
the config's dispatcher, named ``module`` as flax names it.

``TorchMultiheadAttention`` is torch's ``nn.MultiheadAttention``,
batch-first, as ``mmf_bert`` composes it: separate ``q_proj``,
``k_proj``, ``v_proj`` and ``out_proj`` (flax's names), the heads through
``dot_product_attention`` (the kernels on the card).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from mmf_tpu_torch.modules.layers import ModalCombineLayer, TransformLayer
from mmf_tpu_torch.modules.transformer import Dense, attend

EPS = 1.0e-08


class TopDownAttention(nn.Module):
    def __init__(self, combine_type: str, image_dim: int, text_dim: int,
                 combine_params: Dict[str, Any], transform_type: str,
                 transform_params: Optional[Dict[str, Any]],
                 normalization: str = "softmax"):
        super().__init__()
        self.combination_layer = ModalCombineLayer(
            combine_type, image_dim, text_dim, combine_params)
        self.transform = TransformLayer(
            transform_type, self.combination_layer.out_dim,
            **(transform_params or {}))
        self.normalization = normalization.lower()
        if self.normalization not in ("softmax", "sigmoid"):
            raise ValueError(normalization)

    @staticmethod
    def _mask_attentions(attention, image_locs):
        idx = torch.arange(attention.shape[1], device=attention.device)
        mask = idx[None, :, None] >= image_locs.reshape(-1, 1, 1)
        return attention.masked_fill(mask, 0.0)

    def forward(self, image_feat, question_embedding, image_locs=None):
        raw = self.transform(self.combination_layer(image_feat,
                                                    question_embedding))
        if self.normalization == "softmax":
            attention = torch.softmax(raw, dim=1)
            if image_locs is None:
                return attention
            masked = self._mask_attentions(attention, image_locs)
            s = masked.sum(dim=1, keepdim=True)
            s = s + (s == 0).to(s.dtype) + EPS
            return masked / s
        attention = torch.sigmoid(raw)
        if image_locs is None:
            return attention
        return self._mask_attentions(attention, image_locs)


class AttentionLayer(nn.Module):
    def __init__(self, image_dim: int, text_dim: int,
                 modal_combine: Dict[str, Any], transform: Dict[str, Any],
                 normalization: str = "softmax"):
        super().__init__()
        mc, tr = dict(modal_combine or {}), dict(transform or {})
        self.module = TopDownAttention(
            mc["type"], image_dim, text_dim, mc.get("params"), tr["type"],
            tr.get("params"), normalization)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)


class TorchMultiheadAttention(nn.Module):
    """``mmf_tpu/modules/attention.py:159``: query [B, Sq, embed_dim],
    key and value [B, Skv, kdim / vdim] -> [B, Sq, embed_dim] over
    ``num_heads`` heads of ``embed_dim / num_heads``. ``key_padding_mask``
    [B, Skv] follows torch: True marks a key to ignore, a -1e9 f32 bias
    of [B, 1, 1, Skv]. Attention-probability dropout at ``dropout`` in
    training mode draws from the installed dropout generator and runs the
    plain version (``modules.transformer.attend``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.q_proj = Dense(embed_dim, embed_dim, dtype)
        self.k_proj = Dense(kdim or embed_dim, embed_dim, dtype)
        self.v_proj = Dense(vdim or embed_dim, embed_dim, dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype)

    def forward(self, query, key, value, key_padding_mask=None):
        b, sq = query.shape[0], query.shape[1]

        def heads(x):
            return x.reshape(b, x.shape[1], self.num_heads, -1).transpose(
                1, 2)

        bias = None
        if key_padding_mask is not None:
            bias = torch.where(key_padding_mask.bool(), -1e9, 0.0).to(
                torch.float32)[:, None, None, :]
        ctx = attend(heads(self.q_proj(query)), heads(self.k_proj(key)),
                     heads(self.v_proj(value)), bias, self.dropout,
                     self.training)
        return self.out_proj(ctx.transpose(1, 2).reshape(b, sq, -1))
