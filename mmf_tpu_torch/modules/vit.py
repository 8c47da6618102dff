"""The Vision Transformer: patch embeddings and a pre-LN encoder.

Port of ``mmf_tpu/modules/vit.py``. ``ViTModel`` takes raw images
(``do_patch_embeddings``) or embeddings already made, which is how ViLT
runs its concatenated text and image embeddings through the encoder.

- ``ViTPatchEmbeddings``: a strided convolution (flax's ``Conv`` kernel
  is HWIO, torch's ``Conv2d`` weight OIHW: ``params_from_jax``
  transposes), a learned ``cls_token`` and ``position_embeddings``.
- ``ViTLayer`` is pre-LN, unlike BERT's post-LN trunk: LayerNorm, then
  attention, then the residual add; LayerNorm, then the MLP, then the
  add. Its LayerNorms have no residual to fuse, so each is
  ``ops.layer_norm`` without one (K4 forward, K4-bwd backward on the
  card) and the adds are separate. flax's ``nn.LayerNorm`` takes the
  variance as E[x^2] - E[x]^2 (clipped at 0), the port's plain version
  as E[(x - mean)^2]: the same function, apart in float32 rounding (the
  tests hold them within 2e-5). eps is ``layer_norm_eps`` (1e-12).
- Attention goes through ``modules.transformer.attend``: the flash
  kernels (K1 in inference, K1-stats, K2 and K3 in training) in the
  config's dtype, the plain version where attention-probability dropout
  is on in training, as in JAX.

Parameter names are the flax paths (``encoder.layer_0.attention_query``,
``layernorm_before``, ...). Dense weights start at zero and
``cls_token`` at zero, ``position_embeddings`` at N(0, 0.02) from an
explicit generator (``init_weights``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmf_tpu_torch.modules.transformer import (
    ACT2FN,
    Dropout,
    Pooler,
    ResidualLayerNorm,
    TransformerConfig,
    _dense,
    attend,
)
from mmf_tpu_torch.ops.attention import make_attention_bias


class ViTPatchEmbeddings(nn.Module):
    """Image [B, 3, H, W] -> [B, 1 + (H / p) * (W / p), hidden]: the patch
    projection in ``dtype``, the class token first, then the position
    embeddings of the first ``1 + patches`` positions."""

    def __init__(self, hidden_size: int = 768, patch_size: int = 16,
                 image_size: int = 224, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.projection = nn.Conv2d(in_channels, hidden_size, patch_size,
                                    stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        num_positions = (image_size // patch_size) ** 2 + 1
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, num_positions, hidden_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        self.cls_token.zero_()
        w = torch.empty(self.position_embeddings.shape, dtype=torch.float32)
        self.position_embeddings.copy_(w.normal_(0.0, std,
                                                 generator=generator))

    def forward(self, pixel_values):
        dt = self.dtype
        x = nn.functional.conv2d(
            pixel_values.to(dt), self.projection.weight.to(dt),
            self.projection.bias.to(dt), stride=self.projection.stride)
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, c), x], dim=1)
        return x + self.position_embeddings[:, :x.shape[1]].to(dt)


class ViTLayer(nn.Module):
    """Pre-LN block: LN -> attention -> + residual; LN -> MLP -> +
    residual (HF ``ViTLayer``)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        hs = config.hidden_size
        self.layernorm_before = ResidualLayerNorm(hs, config.layer_norm_eps)
        self.attention_query = _dense(config, hs, hs)
        self.attention_key = _dense(config, hs, hs)
        self.attention_value = _dense(config, hs, hs)
        self.attention_output_dense = _dense(config, hs, hs)
        self.layernorm_after = ResidualLayerNorm(hs, config.layer_norm_eps)
        self.intermediate_dense = _dense(config, hs, config.intermediate_size)
        self.output_dense = _dense(config, config.intermediate_size, hs)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, hidden, bias=None):
        cfg = self.config
        nh = cfg.num_attention_heads
        d = cfg.hidden_size // nh

        def split(t):
            return t.view(t.shape[0], t.shape[1], nh, d).transpose(1, 2)

        x = self.layernorm_before(hidden)
        ctx = attend(split(self.attention_query(x)),
                     split(self.attention_key(x)),
                     split(self.attention_value(x)), bias,
                     cfg.attention_probs_dropout_prob, self.training)
        ctx = ctx.transpose(1, 2).reshape(x.shape[0], x.shape[1],
                                          cfg.hidden_size)
        hidden = hidden + self.dropout(self.attention_output_dense(ctx))
        y = self.intermediate_dense(self.layernorm_after(hidden))
        y = self.output_dense(ACT2FN[cfg.hidden_act](y))
        return hidden + self.dropout(y)


class ViTEncoder(nn.Module):
    """``layer_0`` ... ``layer_{n-1}``."""

    def __init__(self, config: TransformerConfig,
                 num_layers: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers or config.num_hidden_layers
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", ViTLayer(config))

    def forward(self, hidden, bias=None):
        for i in range(self.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, bias)
        return hidden


class ViTModel(nn.Module):
    """Patch embeddings (when ``do_patch_embeddings``), the encoder with
    the padding mask as an additive bias, the final LayerNorm and (when
    ``add_pooling_layer``) the pooler. Returns (sequence, pooled or
    None). Attention-probability dropout is ``TransformerConfig``'s
    0.1, as in JAX, which builds the config without it."""

    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12,
                 intermediate_size: int = 3072, patch_size: int = 16,
                 image_size: int = 224, layer_norm_eps: float = 1e-12,
                 hidden_dropout_prob: float = 0.0,
                 do_patch_embeddings: bool = True,
                 add_pooling_layer: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = TransformerConfig(
            hidden_size=hidden_size, num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            intermediate_size=intermediate_size,
            layer_norm_eps=layer_norm_eps,
            hidden_dropout_prob=hidden_dropout_prob, dtype=dtype)
        if do_patch_embeddings:
            self.embeddings = ViTPatchEmbeddings(hidden_size, patch_size,
                                                 image_size, dtype)
        self.encoder = ViTEncoder(self.config)
        self.layernorm = ResidualLayerNorm(hidden_size, layer_norm_eps)
        self.pooler = Pooler(self.config) if add_pooling_layer else None

    def forward(self, x, attention_mask=None):
        if hasattr(self, "embeddings"):
            x = self.embeddings(x)
        bias = None
        if attention_mask is not None:
            bias = make_attention_bias(attention_mask, self.config.dtype)
        seq = self.layernorm(self.encoder(x, bias))
        return seq, (self.pooler(seq) if self.pooler is not None else None)
