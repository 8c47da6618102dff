"""LoRRA: Pythia with an OCR context branch.

Port of ``mmf_tpu/models/lorra.py``. Besides Pythia's question and
image branches, the OCR tokens' vectors (``context_feature_0``, FastText
300 wide) are pooled under the question's attention, normalised by a
sigmoid and masked past ``context_info_0.max_features`` (the
``context_feature_embeddings`` of ``configs/models/lorra/defaults.yaml``),
with the ``order_vectors`` (one row a token slot) appended after the
attention. The combine layer's ``context_dim`` arm adds
``fa_context(context) * fa_txt(text)`` beside the image's product, and
the ``logit`` classifier scores the answers and the OCR copy slots
(``soft_copy_answer``'s ``num_vocab + max_length``).

flax infers the context branch's widths; here they come from the
config: ``context_feature_dim`` (300) and ``context_max_len`` (50, the
order vectors' width); the combine layer's ``context_dim`` (350) is the
two together.
"""

from __future__ import annotations

from typing import Any, Dict

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.pythia import Pythia


@registry.register_model("lorra")
class LoRRA(Pythia):
    def _build(self):
        super()._build()
        self._build_feature_embeddings(
            "context", self.text_dim,
            self.config.get("context_feature_dim", 300),
            len(self.config["context_feature_encodings"]),
            extra_dim=self.config.get("context_max_len", 50))

    @classmethod
    def config_path(cls):
        return "configs/models/lorra/defaults.yaml"

    def forward(self, sample_list: Dict[str, Any]):
        text_total = self._text_total(sample_list)
        image_total = self._image_total(sample_list, text_total)
        extra = {"order_vectors": sample_list.get("order_vectors", None)}
        context_total = self._feature_embedding_total(
            "context", sample_list, text_total, extra)
        joint = self.image_text_multi_modal_combine_layer(
            image_total, text_total, context_total)
        return {"scores": self.classifier(joint)}
