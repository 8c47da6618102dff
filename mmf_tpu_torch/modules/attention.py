"""Top-down attention over region features: the part of
``mmf_tpu/modules/attention.py`` that the Pythia family uses.

``TopDownAttention`` combines the regions with the question embedding
(``ModalCombineLayer``), maps each region to one raw score
(``TransformLayer``) and normalises over the regions: a softmax whose
regions past ``image_locs`` are zeroed and the rest renormalised
(``s + (s == 0) + 1e-8``), or a sigmoid, masked. ``AttentionLayer`` is
the config's dispatcher, named ``module`` as flax names it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from mmf_tpu_torch.modules.layers import ModalCombineLayer, TransformLayer

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
