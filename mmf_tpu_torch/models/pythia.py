"""The Pythia family: ``pythia``, ``pythia_question_only``,
``pythia_image_only`` and ``multihead``.

Port of ``mmf_tpu/models/pythia.py``. A word table (300 wide) feeds the
configured text embeddings (Pythia's VQA2 config: an LSTM with
convolutional attention over the words); each configured image
encoding, while the batch holds ``image_feature_<i>``, encodes the
regions (``finetune_faster_rcnn_fpn_fc7``, then ``default``) and each
image-feature embedding pools them under question-guided top-down
attention; the pooled image and the text meet in the combine layer
(``non_linear_element_multiply``) and the ``logit`` classifier scores
the answers. The ablations keep one arm: ``pythia_question_only``
scores the combine layer's text arm on a zeroed text embedding with the
classifier's text branch alone; ``pythia_image_only`` pools the regions
under a zeroed text embedding and scores the combine layer's image arm.
The arms flax never calls are not built, so the parameters are flax's.

flax infers widths at the first call; here they come from the config:
``image_feature_dim`` is the regions' width, the word table's size is
the first dataset's text processor's vocabulary (the registry's
``<dataset>_text_processor``, else ``text_vocab_size``) and the answers
are ``<dataset>_num_final_outputs`` (else ``num_labels``). The
encodings built are as many as the first dataset's features give
(``image_feature_0`` for each comma-joined path of its first training
features entry), at most the configured ones: VQA2's one.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import torch

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.embeddings import (
    ImageFeatureEmbedding,
    MultiHeadImageFeatureEmbedding,
    TextEmbedding,
)
from mmf_tpu_torch.modules.encoders import build_image_encoder
from mmf_tpu_torch.modules.layers import ClassifierLayer, ModalCombineLayer
from mmf_tpu_torch.modules.transformer import Embed

WORD_DIM = 300


def _dataset_config():
    cfg = registry.get("config", no_warning=True)
    return cfg.get("dataset_config", None) if cfg is not None else None


@registry.register_model("pythia")
class Pythia(BaseModel):
    # which arms of the combine layer and classifier the model calls
    branch: Optional[str] = None

    def __init__(self, config: Any = None):
        super().__init__(config)
        self._build()

    def _build(self):
        self.word_embedding = Embed(self._vocab_size(), WORD_DIM)
        text_dim = 0
        for i, te_cfg in enumerate(self.config["text_embeddings"]):
            emb = TextEmbedding(te_cfg["type"], te_cfg.get("params", {}))
            self.add_module(f"text_embeddings_{i}", emb)
            text_dim += emb.out_dim
        self.text_dim = text_dim
        image_dim = self._build_image_embeddings(text_dim) \
            if self.branch != "text" else 0
        cc = self.config["image_text_modal_combine"]
        self.image_text_multi_modal_combine_layer = ModalCombineLayer(
            cc["type"], image_dim, text_dim, cc.get("params", {}),
            branch=self.branch)
        ccl = self.config["classifier"]
        self.classifier = ClassifierLayer(
            ccl["type"], 0, self._num_choices(), ccl.get("params", {}),
            in_features=self.image_text_multi_modal_combine_layer.out_dim,
            branch=self.branch)

    @classmethod
    def config_path(cls):
        return "configs/models/pythia/defaults.yaml"

    def materialize_from_state_dict(self, state_dict):
        """Rebuild for the feature sets a checkpoint's weights hold, where
        they are more or fewer than the built ones: a served model has no
        dataset config to count them from (flax takes them from the
        batch)."""
        if not hasattr(self, "image_encoder_names"):
            return
        sets = {int(m.group(1)) for m in (
            re.match(r"image_feature_embeddings_(\d+)_", k)
            for k in state_dict) if m}
        if sets and len(sets) != len(self.image_encoder_names):
            self._feature_sets = len(sets)
            self._modules.clear()
            self.encoder_names = []
            self._build()

    @classmethod
    def format_state_key(cls, key):
        return key.replace("fa_history", "fa_context")

    def _datasets(self) -> List[str]:
        cfg = registry.get("config", no_warning=True)
        if cfg is not None and cfg.get("datasets", None):
            d = cfg["datasets"]
            return d.split(",") if isinstance(d, str) else list(d)
        return [self.config.get("datasets", "vqa2")]

    def _num_choices(self) -> int:
        num = registry.get(self._datasets()[0] + "_num_final_outputs",
                           no_warning=True)
        return num if num is not None else self.config.get("num_labels",
                                                           3129)

    def _vocab_size(self) -> int:
        tp = registry.get(self._datasets()[0] + "_text_processor",
                          no_warning=True)
        if tp is not None and hasattr(tp, "get_vocab_size"):
            return tp.get_vocab_size()
        return self.config.get("text_vocab_size", 100000)

    def _num_feature_sets(self) -> int:
        """Feature sets the first dataset gives a sample (one a
        comma-joined path of its first training features entry)."""
        if getattr(self, "_feature_sets", None):
            return self._feature_sets
        ds = _dataset_config()
        name = self._datasets()[0].strip()
        if ds is None or name not in ds:
            return 1
        features = (ds[name].get("features", {}) or {}).get("train", None)
        if not features:
            return 1
        return len(str(features[0]).split(","))

    def _build_image_embeddings(self, text_dim: int) -> int:
        return self._build_feature_embeddings(
            "image", text_dim, self.config.get("image_feature_dim", 2048),
            self._num_feature_sets())

    def _build_feature_embeddings(self, attr: str, text_dim: int,
                                  feature_dim: int, n_sets: int,
                                  extra_dim: int = 0) -> int:
        """The encoders and embeddings of ``attr``'s first ``n_sets``
        configured encodings (``<attr>_feature_encodings``) over
        ``feature_dim``-wide features; each embedding pools the encoded
        features with ``extra_dim`` more columns (the order vectors).
        Returns the pooled width of them all."""
        encodings = self.config[f"{attr}_feature_encodings"]
        width = 0
        # flax names an unnamed module after its class and a count, over
        # the model's whole scope (the context's after the image's)
        if not hasattr(self, "encoder_names"):
            self.encoder_names: List[str] = []
        names = []
        for i in range(min(len(encodings), n_sets)):
            params = dict(encodings[i].get("params", {}) or {})
            params.setdefault("in_dim", feature_dim)
            encoder = build_image_encoder(
                {"type": encodings[i]["type"], "params": params},
                direct_features=True)
            base = type(encoder).__name__
            seen = sum(n.startswith(base + "_") for n in self.encoder_names)
            name = f"{base}_{seen}"
            self.add_module(name, encoder)
            self.encoder_names.append(name)
            names.append(name)
            for j, fe_cfg in enumerate(
                    self.config[f"{attr}_feature_embeddings"]):
                emb, out_dim = self._feature_embedding(
                    encoder.out_dim, text_dim, fe_cfg, extra_dim)
                self.add_module(f"{attr}_feature_embeddings_{i}_{j}", emb)
                width += out_dim
        setattr(self, f"{attr}_encoder_names", names)
        return width

    def _feature_embedding(self, image_dim: int, text_dim: int, fe_cfg,
                           extra_dim: int = 0):
        """One feature embedding and the width it gives: Pythia's
        top-down pooling, ``out_dim`` maps of the features (with
        ``extra_dim`` columns appended after the attention)."""
        emb = ImageFeatureEmbedding(
            image_dim, text_dim, fe_cfg["modal_combine"],
            fe_cfg["transform"], fe_cfg.get("normalization", "softmax"))
        out = (fe_cfg["transform"].get("params", {}) or {}).get("out_dim", 1)
        return emb, (image_dim + extra_dim) * out

    def _text_total(self, sample_list):
        words = self.word_embedding(sample_list["text"].long())
        return torch.cat([getattr(self, f"text_embeddings_{i}")(words)
                          for i in range(len(self.config["text_embeddings"]))],
                         dim=1)

    def _image_total(self, sample_list, text_total):
        return self._feature_embedding_total("image", sample_list,
                                             text_total)

    def _feature_embedding_total(self, attr: str, sample_list, text_total,
                                 extra: Optional[Dict[str, Any]] = None):
        """``attr``'s features (``<attr>_feature_<i>`` while the batch
        holds them) through their encoders and embeddings, masked past
        ``<attr>_info_<i>.max_features``; ``extra``'s order vectors are
        appended after the attention. The pooled features, concatenated."""
        names = getattr(self, f"{attr}_encoder_names")
        pooled = []
        for i in range(len(self.config[f"{attr}_feature_encodings"])):
            feature = sample_list.get(f"{attr}_feature_{i}", None)
            if feature is None:
                break
            if i >= len(names):
                raise ValueError(
                    f"the batch holds {attr}_feature_{i}, and the model was "
                    f"built for {len(names)} feature sets (the first "
                    "dataset's features)")
            info = sample_list.get(f"{attr}_info_{i}", {}) or {}
            dims = info.get("max_features", None)
            if dims is None:
                dims = torch.full((feature.shape[0],), feature.shape[1],
                                  device=feature.device)
            encoded = getattr(self, names[i])(feature)
            for j in range(len(self.config[f"{attr}_feature_embeddings"])):
                emb, _ = getattr(self, f"{attr}_feature_embeddings_{i}_{j}")(
                    encoded, text_total, dims, extra)
                pooled.append(emb)
        return torch.cat(pooled, dim=1)

    def forward(self, sample_list: Dict[str, Any]):
        text_total = self._text_total(sample_list)
        image_total = self._image_total(sample_list, text_total)
        joint = self.image_text_multi_modal_combine_layer(image_total,
                                                          text_total)
        return {"scores": self.classifier(joint)}


@registry.register_model("pythia_question_only")
class PythiaQuestionOnly(Pythia):
    """The text arm alone, on a zeroed text embedding, scored by the
    classifier's text branch."""

    branch = "text"

    def forward(self, sample_list: Dict[str, Any]):
        text_total = torch.zeros_like(self._text_total(sample_list))
        joint = self.image_text_multi_modal_combine_layer(
            text_total, text_total, branch="text")
        return {"scores": self.classifier(joint, branch="text")}


@registry.register_model("pythia_image_only")
class PythiaImageOnly(Pythia):
    """The regions pooled under a zeroed text embedding, through the
    combine layer's image arm and the whole classifier."""

    branch = "image"

    def forward(self, sample_list: Dict[str, Any]):
        text_total = torch.zeros_like(self._text_total(sample_list))
        image_total = self._image_total(sample_list, text_total)
        joint = self.image_text_multi_modal_combine_layer(
            image_total, image_total, branch="image")
        return {"scores": self.classifier(joint)}


@registry.register_model("multihead")
class PythiaMultiHead(Pythia):
    """Pythia with multi-head attention from the question to the regions
    (``mmf_tpu/models/pythia.py:186``): each image-feature embedding is a
    ``MultiHeadImageFeatureEmbedding`` of the config's ``num_heads``
    (8), as wide as the text embedding."""

    def _feature_embedding(self, image_dim: int, text_dim: int, fe_cfg,
                           extra_dim: int = 0):
        return MultiHeadImageFeatureEmbedding(
            image_dim, text_dim, num_heads=fe_cfg.get("num_heads", 8)), \
            text_dim
