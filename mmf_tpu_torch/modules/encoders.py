"""Encoders (the part of ``mmf_tpu/modules/encoders.py`` that MMBT and
the Hateful Memes baselines use).

Registered: ``identity``, ``resnet152`` (grid features from ResNet-152),
``text_embedding`` (a ``TextEmbedding`` reduced over the tokens) and
``transformer`` (a BERT-style ``TransformerModel`` in float32, JAX's
default dtype, whose type table ``num_segments`` widens; it returns the
pooled output). ``build_image_encoder`` and ``build_text_encoder`` keep
the JAX factories' config contract (``embedding`` is the text factory's
alias of ``text_embedding``); with ``direct_features`` the image factory
builds ``identity`` (``default``) and ``finetune_faster_rcnn_fpn_fc7``
(``ImageFinetune`` over region features) and ``projection``
(``ProjectionEmbedding``, ``module`` defaulting to ``linear``).
Pretrained ImageNet weights are not loaded (``pretrained`` is accepted
and ignored, as in the JAX package): ``BaseModel.init_weights`` fills the
ResNet from a seed.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.modules.resnet import ResNet

# num_output_features -> adaptive pooling grid, as the reference's table
POOL_GRIDS = {1: (1, 1), 2: (2, 1), 3: (3, 1), 4: (2, 2), 5: (5, 1),
              6: (3, 2), 7: (7, 1), 8: (4, 2), 9: (3, 3)}


def adaptive_pool_2d(x: torch.Tensor, out_hw, pool_type: str = "avg"):
    """Adaptive avg/max pool, NHWC -> [B, oh, ow, C] (torch semantics:
    window i spans rows floor(i h / oh) .. ceil((i + 1) h / oh))."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    rows = []
    for i in range(oh):
        hs, he = (i * h) // oh, -(-((i + 1) * h) // oh)
        cols = []
        for j in range(ow):
            ws, we = (j * w) // ow, -(-((j + 1) * w) // ow)
            patch = x[:, hs:he, ws:we, :]
            cols.append(patch.mean(dim=(1, 2)) if pool_type == "avg"
                        else patch.amax(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)


class Encoder(nn.Module):
    """Base encoder (reference encoders.py:44-57)."""

    @classmethod
    def from_params(cls, **kwargs):
        return cls(**kwargs)


@registry.register_encoder("identity")
class IdentityEncoder(Encoder):
    def __init__(self, in_dim: int = 100):
        super().__init__()
        self.in_dim = in_dim

    @property
    def out_dim(self):
        return self.in_dim

    def forward(self, x, *args, **kwargs):
        return x


@registry.register_encoder("resnet152")
class ResNet152ImageEncoder(Encoder):
    """Grid features from ResNet-152: [B, 3, H, W] -> [B, N, 2048], with
    N = ``num_output_features`` adaptive-pooled cells (-1: the whole
    grid)."""

    def __init__(self, pretrained: bool = True, pool_type: str = "avg",
                 num_output_features: int = 1):
        super().__init__()
        self.pool_type = pool_type
        self.num_output_features = num_output_features
        self.model = ResNet(depth=152, features_only=True)

    @property
    def out_dim(self):
        return 2048

    def forward(self, x, *args, **kwargs):
        feats = self.model(x)
        n = self.num_output_features
        pooled = feats if n == -1 else adaptive_pool_2d(
            feats, POOL_GRIDS[n], self.pool_type)
        return pooled.reshape(pooled.shape[0], -1, pooled.shape[-1])


@registry.register_encoder("text_embedding")
class TextEmbeddingEncoder(Encoder):
    """A ``TextEmbedding`` of the tokens, reduced over them by
    ``operator``: ``sum``, ``concat`` (flattened), ``mul`` (product) or
    none."""

    def __init__(self, operator: str = "sum", embedding_params=None):
        super().__init__()
        from mmf_tpu_torch.modules.embeddings import TextEmbedding

        p = dict(embedding_params or {})
        self.operator = operator
        self.module = TextEmbedding(p.get("type", "vocab"),
                                    p.get("params", {}))

    @property
    def out_dim(self):
        if self.operator not in ("sum", "mul"):
            raise ValueError(
                f"the width of operator {self.operator!r} depends on the "
                "sequence length")
        return self.module.out_dim

    def forward(self, x, *args, **kwargs):
        x = self.module(x)
        if self.operator == "sum":
            return x.sum(dim=1)
        if self.operator == "concat":
            return x.reshape(x.shape[0], -1)
        if self.operator == "mul":
            return torch.prod(x, dim=1)
        return x


@registry.register_encoder("transformer")
class TransformerEncoderWrapper(Encoder):
    """A BERT-style text encoder in float32: ``module`` is the shared
    ``TransformerModel``; ``num_segments`` widens its type table.
    ``forward(input_ids, attention_mask, token_type_ids)`` returns the
    pooled output (the sequence with ``return_sequence``). Its dropout
    rates are ``TransformerConfig``'s (0.1), which no config key
    reaches, as in JAX."""

    def __init__(self, bert_model_name: str = "bert-base-uncased",
                 hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, vocab_size: int = 30522,
                 max_position_embeddings: int = 512,
                 type_vocab_size: int = 2, num_segments=None,
                 output_attentions: bool = False,
                 output_hidden_states: bool = False,
                 random_init: bool = False):
        super().__init__()
        from mmf_tpu_torch.modules.transformer import (
            TransformerConfig,
            TransformerModel,
        )

        self.hidden_size = hidden_size
        self.module = TransformerModel(TransformerConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            intermediate_size=hidden_size * 4,
            max_position_embeddings=max_position_embeddings,
            type_vocab_size=num_segments or type_vocab_size,
            dtype=torch.float32))

    @property
    def out_dim(self):
        return self.hidden_size

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                return_sequence=False):
        seq, pooled = self.module(input_ids, attention_mask, token_type_ids)
        return seq if return_sequence else pooled


@registry.register_encoder("finetune_faster_rcnn_fpn_fc7")
class FinetuneFasterRcnnFpnFc7(nn.Module):
    """fc6 -> fc7 finetune over region features (reference
    encoders.py:116), an ``ImageFinetune`` named ``module``. Its weights
    come from ``weights_file`` / ``bias_file`` when they exist, else
    they are drawn; ``model_data_dir`` is accepted and unused, as in
    JAX."""

    def __init__(self, in_dim: int = 2048, weights_file: str = None,
                 bias_file: str = None, model_data_dir: str = None):
        super().__init__()
        from mmf_tpu_torch.modules.embeddings import ImageFinetune

        self.module = ImageFinetune(in_dim, weights_file, bias_file)

    @property
    def out_dim(self):
        return self.module.out_dim

    def forward(self, image_feat, *args, **kwargs):
        return self.module(image_feat)


def _construct(cls, params: Dict[str, Any]):
    """``cls`` from the config params its constructor names."""
    names = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in params.items() if k in names})


def build_image_encoder(config, direct_features: bool = False):
    etype = config.get("type", "resnet152")
    params = dict(config.get("params", {}) or {})
    if direct_features:
        # image-feature encoders operate on precomputed region features
        if etype in ("default", "identity"):
            return IdentityEncoder(in_dim=params.get("in_dim", 2048))
        if etype == "finetune_faster_rcnn_fpn_fc7":
            return _construct(FinetuneFasterRcnnFpnFc7, params)
        if etype == "projection":
            from mmf_tpu_torch.modules.embeddings import ProjectionEmbedding

            params.setdefault("module", "linear")
            return _construct(ProjectionEmbedding, params)
        raise NotImplementedError(f"Unknown Image Feature Encoder: {etype}")
    cls = registry.get_encoder_class(etype)
    if cls is None:
        raise NotImplementedError(f"Unknown Image Encoder: {etype}")
    return _construct(cls, params)


def build_text_encoder(config):
    etype = config.get("type", "transformer")
    if etype == "embedding":  # the text factory's alias
        etype = "text_embedding"
    cls = registry.get_encoder_class(etype)
    if cls is None:
        raise NotImplementedError(f"Unknown Text Encoder: {etype}")
    return _construct(cls, dict(config.get("params", {}) or {}))
