"""BaseModel: the contract every registered model of the port implements.

Port of ``mmf_tpu/models/base_model.py`` on ``torch.nn.Module``: a model
is built from its ``model_config`` section and maps a sample-list dict of
tensors to ``{"scores": ...}``. It also names its losses
(``build_losses``), lr multipliers and weight-decay mask, which the
optimizer turns into parameter groups.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry


class BaseModel(nn.Module):
    """Base class for all registered models. Subclasses build their
    modules in ``__init__(config)`` and implement ``forward(sample_list)``
    returning a dict with at least ``scores``."""

    def __init__(self, config: Any = None):
        super().__init__()
        self.config = config

    @classmethod
    def config_path(cls) -> Optional[str]:
        """Path to the model's default YAML."""
        return None

    @classmethod
    def format_state_key(cls, key: str) -> str:
        """Map old/pretrained checkpoint keys to current names."""
        return key

    @classmethod
    def from_params(cls, **kwargs):
        from mmf_tpu_torch.config import omega

        return cls(config=omega.create(kwargs))

    def get_lr_multipliers(self, config=None):
        """Per-module lr scales as {parameter-name prefix: scale}; None
        means uniform."""
        return None

    def get_weight_decay_mask(self, config=None):
        """Callable ``model -> {name: decay}`` (True = decay), or None for
        uniform decay. BERT-family models return ``bert_no_decay_mask()``
        (bias and LayerNorm parameters get weight decay 0)."""
        return None

    def build_losses(self):
        """The loss container from ``config.losses``. Dict-style losses
        are resolved inside a model's heads, not here."""
        from mmf_tpu_torch.modules.losses import Losses

        loss_list = []
        if self.config is not None:
            loss_list = self.config.get("losses", []) or []
        if hasattr(loss_list, "keys"):
            loss_list = []
        return Losses(loss_list)

    def has_uninitialized_params(self) -> bool:
        """Whether a layer still waits for its input width (a
        ``LazyDense``). A model with such a layer defines
        ``materialize(sample_list)``, which sizes it from a batch as flax
        does at init; call it before ``init_weights`` and before an
        optimizer is built."""
        return any(isinstance(p, nn.UninitializedParameter)
                   for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     std: float = 0.02) -> "BaseModel":
        """Random weights from an explicit generator, in a fixed module
        order: dense (``Dense`` and ``QuantDense``) and embedding weights
        ~ N(0, std), dense biases 0, LayerNorm scale 1 and bias 0;
        convolution kernels He-normal over the fan-out (std sqrt(2 /
        (out_channels * kh * kw)), a 1-D one's over out_channels * w, so
        activations stay O(1) through a deep ResNet), BatchNorm weight 1,
        bias 0, running mean 0 and
        running variance 1. A module with weights from files
        (``ImageFinetune``'s pickles) takes them again afterwards, and one
        with a constant initialiser (``LanguageDecoder``'s
        ``fc_bias_init``) its constants; an LSTM cell's products are
        Dense layers, weight-norm gains stay 1; a module with parameters
        of its own (BCNet's ``h_mat``) draws them with ``init_params``."""
        from mmf_tpu_torch.modules.embeddings import Conv1d
        from mmf_tpu_torch.modules.resnet import BatchNorm
        from mmf_tpu_torch.modules.transformer import (
            Dense,
            Embed,
            ResidualLayerNorm,
        )
        from mmf_tpu_torch.ops.quant import QuantDense

        def normal(p, sd):
            w = torch.empty(p.shape, dtype=torch.float32)
            w.normal_(0.0, sd, generator=generator)
            p.copy_(w)

        for module in self.modules():
            if isinstance(module, (Dense, QuantDense, Embed)):
                normal(module.weight, std)
                if isinstance(module, (Dense, QuantDense)) and \
                        module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, ResidualLayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Conv2d):
                o, _, kh, kw = module.weight.shape
                normal(module.weight, (2.0 / (o * kh * kw)) ** 0.5)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, Conv1d):
                w, _, o = module.weight.shape
                normal(module.weight, (2.0 / (o * w)) ** 0.5)
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
            elif hasattr(module, "init_params"):  # its own parameters
                module.init_params(normal)
        for module in self.modules():
            if hasattr(module, "init_constants"):
                module.init_constants()
            if hasattr(module, "load_pretrained"):
                module.load_pretrained()
        return self

    @torch.no_grad()
    def to_compute_dtype(self) -> "BaseModel":
        """Cast every ``Dense``/``Embed`` weight to its compute dtype once
        (flax casts float32 params on every call; the rounding is the
        same). For inference. Left in float32: LayerNorm parameters,
        ``QuantDense`` weights (quantised from float32 on every call, as
        in JAX; a bf16 weight would move every column scale) and
        convolutions and BatchNorm (the ResNet computes in float32, as a
        flax ``nn.Conv`` without a dtype does on an f32 image)."""
        from mmf_tpu_torch.modules.transformer import Dense, Embed

        for module in self.modules():
            if isinstance(module, (Dense, Embed)):
                for p in module.parameters(recurse=False):
                    p.data = p.data.to(module.compute_dtype)
        return self

    def forward(self, sample_list: Dict[str, Any]):
        raise NotImplementedError


def build_model(config) -> BaseModel:
    """Instantiate the configured model."""
    model_name = config["model"]
    model_cls = registry.get_model_class(model_name)
    if model_cls is None:
        raise RuntimeError(
            f"No model registered for name: {model_name}. "
            f"Registered: {registry.list_models()}"
        )
    return model_cls(config=config["model_config"][model_name])
