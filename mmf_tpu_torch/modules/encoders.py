"""Image encoders (the part of ``mmf_tpu/modules/encoders.py`` that MMBT
uses).

Registered: ``identity`` and ``resnet152`` (grid features from
ResNet-152). ``build_image_encoder`` keeps the JAX factory's config
contract; with ``direct_features`` it builds ``identity`` only, and the
other feature encoders (``projection``, ``finetune_faster_rcnn_fpn_fc7``)
raise ``NotImplementedError`` naming the module that is not ported.
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
        if etype in ("projection", "finetune_faster_rcnn_fpn_fc7"):
            missing = ("ProjectionEmbedding" if etype == "projection"
                       else "ImageFinetune")
            raise NotImplementedError(
                f"image feature encoder {etype!r} needs {missing}, which "
                "is not ported yet; use type identity"
            )
        raise NotImplementedError(f"Unknown Image Feature Encoder: {etype}")
    cls = registry.get_encoder_class(etype)
    if cls is None:
        raise NotImplementedError(f"Unknown Image Encoder: {etype}")
    return _construct(cls, params)
