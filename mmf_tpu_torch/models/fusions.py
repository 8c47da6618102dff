"""The fusion baselines of Hateful Memes: ``concat_bert``, ``concat_bow``
and ``late_fusion``.

Port of ``mmf_tpu/models/fusions.py``. ``FusionBase`` (module ``base``)
encodes the text (``build_text_encoder``: a float32 BERT for
``concat_bert`` and ``late_fusion``, a summed vocabulary embedding for
``concat_bow``) and the image (the ResNet-152 grid encoder on raw
images, or, with ``direct_features_input``, a feature encoder over
``image_feature_0``), each flattened per sample. ``concat_*`` classify
the concatenation; ``late_fusion`` averages a text and an image
classifier. Encoder modules carry flax's auto-generated names
(``TransformerEncoderWrapper_0``, ``ResNet152ImageEncoder_0``, ...).

flax infers the classifiers' input widths from the first batch; here
they come from the encoders: the text encoder's width, and the image
encoder's times its ``num_output_features`` (with direct features, the
feature width times the config's ``num_features``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.encoders import (
    build_image_encoder,
    build_text_encoder,
)
from mmf_tpu_torch.modules.layers import ClassifierLayer


def _flax_name(module: nn.Module) -> str:
    return f"{type(module).__name__}_0"


def _image_width(encoder: nn.Module, direct: bool, config) -> int:
    """Width of the flattened image encoding of one sample."""
    if direct:
        return encoder.out_dim * int(config.get("num_features", 1))
    n = getattr(encoder, "num_output_features", 1)
    if n == -1:
        raise ValueError("num_output_features -1 (the whole grid) gives a "
                         "width that depends on the image size")
    return encoder.out_dim * n


def image_encoder_from_config(config, direct: bool):
    default = ({"type": "default", "params": {}} if direct
               else {"type": "resnet152", "params": {}})
    return build_image_encoder(dict(config.get("modal_encoder", default)),
                               direct_features=direct)


def text_encoder_from_config(config):
    return build_text_encoder(config.get(
        "text_encoder", {"type": "transformer", "params": {}}))


def encode_text(encoder, text, text_args):
    out = encoder(text, *text_args)
    if isinstance(out, (tuple, list)):
        out = out[1] if len(out) >= 2 else out[0]
    return out.reshape(out.shape[0], -1)


class FusionBase(nn.Module):
    """The text and the image encoder; ``forward`` returns both
    encodings flattened per sample."""

    def __init__(self, config):
        super().__init__()
        self.direct = config.get("direct_features_input", False)
        text = text_encoder_from_config(config)
        modal = image_encoder_from_config(config, self.direct)
        self.text_name, self.modal_name = _flax_name(text), _flax_name(modal)
        self.add_module(self.text_name, text)
        self.add_module(self.modal_name, modal)
        self.text_width = text.out_dim
        self.modal_width = _image_width(modal, self.direct, config)

    def forward(self, text, modal, text_args=()):
        modal_out = getattr(self, self.modal_name)(modal)
        text_out = encode_text(getattr(self, self.text_name), text,
                               text_args)
        return text_out, modal_out.reshape(modal_out.shape[0], -1)


def build_classifier(config, in_features: int,
                     key: str = "classifier") -> ClassifierLayer:
    """``config[key]`` as a ``ClassifierLayer`` over ``in_features``:
    ``out_dim`` defaults to ``num_labels``; ``in_dim`` is dropped (JAX
    builds the layer with ``in_dim`` 0)."""
    cc = config[key]
    params = dict(cc.get("params", {}) or {})
    out_dim = params.pop("out_dim", config.get("num_labels", 2))
    params.pop("in_dim", None)
    return ClassifierLayer(cc["type"], 0, out_dim, params=params,
                           in_features=in_features)


def _modal_input(sample_list, direct: bool):
    return sample_list["image_feature_0" if direct else "image"]


class _BertTextFusion(BaseModel):
    """What ``concat_bert`` and ``late_fusion`` share: BERT inputs."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        self.base = FusionBase(self.config)

    def _encode(self, sample_list):
        return self.base(sample_list["input_ids"],
                         _modal_input(sample_list, self.base.direct),
                         (sample_list["input_mask"],
                          sample_list["segment_ids"]))


@registry.register_model("concat_bert")
class ConcatBERT(_BertTextFusion):
    def __init__(self, config: Any = None):
        super().__init__(config)
        self.classifier = build_classifier(
            self.config, self.base.text_width + self.base.modal_width)

    @classmethod
    def config_path(cls):
        return "configs/models/fusions/concat_bert.yaml"

    def get_weight_decay_mask(self, config=None):
        """Bias, LayerNorm and other flax ``scale`` parameters are exempt
        from weight decay (``bert_no_decay_mask``), as in the JAX
        model."""
        from mmf_tpu_torch.utils.modeling import bert_no_decay_mask

        return bert_no_decay_mask()

    def forward(self, sample_list: Dict[str, Any]):
        text, modal = self._encode(sample_list)
        return {"scores": self.classifier(torch.cat([text, modal], -1))}


@registry.register_model("concat_bow")
class ConcatBoW(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        self.base = FusionBase(self.config)
        self.classifier = build_classifier(
            self.config, self.base.text_width + self.base.modal_width)

    @classmethod
    def config_path(cls):
        return "configs/models/fusions/concat_bow.yaml"

    def forward(self, sample_list: Dict[str, Any]):
        text, modal = self.base(sample_list["text"],
                                _modal_input(sample_list, self.base.direct))
        return {"scores": self.classifier(torch.cat([text, modal], -1))}


@registry.register_model("late_fusion")
class LateFusion(_BertTextFusion):
    """A text and an image classifier (``text_classifier``,
    ``modal_classifier``, each falling back to ``classifier``),
    averaged."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        cfg = dict(self.config)
        for name, width in (("text_classifier", self.base.text_width),
                            ("modal_classifier", self.base.modal_width)):
            cc = cfg.get(name) or cfg.get("classifier")
            self.add_module(name, build_classifier(dict(cfg, classifier=cc),
                                                   width))

    @classmethod
    def config_path(cls):
        return "configs/models/fusions/late_fusion.yaml"

    def forward(self, sample_list: Dict[str, Any]):
        text, modal = self._encode(sample_list)
        return {"scores": (self.text_classifier(text)
                           + self.modal_classifier(modal)) / 2}
