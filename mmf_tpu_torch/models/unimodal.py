"""The unimodal baselines of Hateful Memes: ``unimodal_text`` and
``unimodal_image``.

Port of ``mmf_tpu/models/unimodal.py``. ``unimodal_text`` encodes BERT
inputs (``input_ids``, ``input_mask``, ``segment_ids``) when the batch
has them, else ``text`` (vocabulary ids); ``unimodal_image`` encodes
``image`` with the ResNet-152 grid encoder, or, with
``direct_features_input``, mean-pools the regions of
``image_feature_0`` first and runs the feature encoder over the mean.
Each classifies the flattened encoding (``classifier``).
"""

from __future__ import annotations

from typing import Any, Dict

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.models.fusions import (
    _flax_name,
    _image_width,
    build_classifier,
    encode_text,
    image_encoder_from_config,
    text_encoder_from_config,
)


@registry.register_model("unimodal_text")
class UnimodalText(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        encoder = text_encoder_from_config(self.config)
        self.encoder_name = _flax_name(encoder)
        self.add_module(self.encoder_name, encoder)
        self.classifier = build_classifier(self.config, encoder.out_dim)

    @classmethod
    def config_path(cls):
        return "configs/models/unimodal/text.yaml"

    def forward(self, sample_list: Dict[str, Any]):
        args = ()
        if "input_ids" in sample_list:
            text = sample_list["input_ids"]
            args = (sample_list["input_mask"], sample_list["segment_ids"])
        else:
            text = sample_list["text"]
        emb = encode_text(getattr(self, self.encoder_name), text, args)
        return {"scores": self.classifier(emb)}


@registry.register_model("unimodal_image")
class UnimodalModal(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        self.direct = self.config.get("direct_features_input", False)
        encoder = image_encoder_from_config(self.config, self.direct)
        self.encoder_name = _flax_name(encoder)
        self.add_module(self.encoder_name, encoder)
        width = (encoder.out_dim if self.direct
                 else _image_width(encoder, False, self.config))
        self.classifier = build_classifier(self.config, width)

    @classmethod
    def config_path(cls):
        return "configs/models/unimodal/image.yaml"

    def forward(self, sample_list: Dict[str, Any]):
        encoder = getattr(self, self.encoder_name)
        if self.direct:
            modal = encoder(sample_list["image_feature_0"].mean(dim=1))
        else:
            modal = encoder(sample_list["image"])
        return {"scores": self.classifier(modal.reshape(modal.shape[0], -1))}
