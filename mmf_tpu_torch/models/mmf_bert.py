"""MMFBert: a BERT-flavoured Pythia.

Port of ``mmf_tpu/models/mmf_bert.py``. BERT's embeddings
(``word_embedding``) feed one multi-head self-attention layer over the
text with key padding (``text_embedding``; not a full encoder stack);
each feature set's regions are encoded, projected to the text width by
the one shared ``image_feature_projection``, optionally attended among
themselves (``image_feature_intra_attention``) and attended from the
text (``image_feature_embeddings_<i>_<j>``); the text and the attended
regions meet in the element-multiply combine layer, a BERT pooler reads
the joint sequence's first position, and one head of
``training_head_type`` scores it:

- ``pretraining``: the masked LM over the joint sequence (``cls``) and
  ``seq_relationship``; the model computes its own losses,
  ``<dataset>/<split>/masked_lm_loss`` (a float32 log_softmax, positions
  labelled -1 left out) and, when the batch has ``is_correct``,
  ``<dataset>/<split>/next_sentence_loss``;
- ``vqa`` / ``vizwiz``: the joint stream at the second-last real token,
  dropout, ``classifier_transform`` and ``classifier_logits``
  (``num_labels``, else 3129, or 7371 for vizwiz);
- ``nlvr2``, ``visual_entailment`` and ``classification``: the pooled
  output, dropout, ``classifier_transform``, ``classifier_logits``
  (``num_labels``, else 2 / 3, or for ``classification`` the first
  dataset's ``<dataset>_num_final_outputs``).

JAX's documented deviations from MMF are kept (``mmf_tpu/models/
mmf_bert.py:11-23``): the MLM decoder is its own matrix (untied), the
next-sentence loss is computed when ``is_correct`` is present, an
``nlvr2`` head exists, and ``classification`` is a generic pooled head.
Any other head type returns an empty dict, as in JAX.

The attentions run ``dot_product_attention``: the card's kernels at
head dim ``embed_dim / num_heads`` (96 at the config's 768 and 8 heads),
the plain version under attention-probability dropout in training
(the config's 0.1). flax infers widths at the first call; here the
feature sets built are as many as the first dataset's features give
(Pythia's ``_num_feature_sets``), each encoder reading
``image_feature_dim`` wide regions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.models.pythia import Pythia
from mmf_tpu_torch.modules.attention import TorchMultiheadAttention
from mmf_tpu_torch.modules.embeddings import ProjectionEmbedding
from mmf_tpu_torch.modules.encoders import build_image_encoder
from mmf_tpu_torch.modules.layers import ModalCombineLayer
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    MLMHead,
    Pooler,
    PredictionHeadTransform,
    TextEmbeddings,
    TransformerConfig,
    _dense,
    masked_lm_loss,
    picked_log_prob,
)


def _attention(p, cfg: TransformerConfig, kdim=None):
    p = dict(p)
    return TorchMultiheadAttention(
        p.get("embed_dim", cfg.hidden_size), p.get("num_heads", 8),
        p.get("dropout", 0.0), kdim=kdim, vdim=kdim, dtype=cfg.dtype)


@registry.register_model("mmf_bert")
class MMFBert(Pythia):
    def __init__(self, config: Any = None):
        BaseModel.__init__(self, config)
        c = self.config
        cfg = self.tcfg = self._tcfg()
        self.head = c.get("training_head_type", "pretraining")
        self.word_embedding = TextEmbeddings(cfg)
        te_list = list(c.get("text_embeddings") or [])
        text_dim = cfg.hidden_size
        if te_list:
            self.text_embedding = _attention(te_list[0], cfg)
            text_dim = dict(te_list[0]).get("embed_dim", cfg.hidden_size)

        feature_dim = c.get("image_feature_dim", 2048)
        proj_cfg = dict(c.get("image_feature_projection") or {
            "module": "linear", "in_dim": feature_dim,
            "out_dim": cfg.hidden_size})
        self.image_feature_projection = ProjectionEmbedding(**proj_cfg)
        projected = self.image_feature_projection.out_dim
        enc_cfgs = list(c.get("image_feature_encodings") or [
            {"type": "default", "params": {}}])
        fe_cfgs = list(c.get("image_feature_embeddings") or [])
        intra_cfgs = list(c.get("image_feature_attentions") or [])
        self.intra = bool(c.get("image_intra_attention", False) and
                          intra_cfgs)
        self.n_embeddings = len(fe_cfgs)
        self.encoder_names = []
        image_dim = 0
        for idx in range(self._num_feature_sets()):
            enc_cfg = dict(enc_cfgs[min(idx, len(enc_cfgs) - 1)])
            params = dict(enc_cfg.get("params", {}) or {})
            params.setdefault("in_dim", feature_dim)
            encoder = build_image_encoder(
                {"type": enc_cfg.get("type", "default"), "params": params},
                direct_features=True)
            # flax names an unnamed module after its class and a count
            base = type(encoder).__name__
            seen = sum(n.startswith(base + "_") for n in self.encoder_names)
            self.encoder_names.append(f"{base}_{seen}")
            self.add_module(self.encoder_names[-1], encoder)
            if self.intra and idx == 0:
                self.image_feature_intra_attention = _attention(
                    intra_cfgs[0], cfg, kdim=projected)
            for j, fp in enumerate(fe_cfgs):
                emb = _attention(fp, cfg, kdim=projected)
                self.add_module(f"image_feature_embeddings_{idx}_{j}", emb)
                image_dim = dict(fp).get("embed_dim", cfg.hidden_size)
        if not image_dim:  # text-only batches: the text in its place
            image_dim = text_dim

        self.combine = c.get("combine_embeddings", True)
        joint_dim = image_dim
        if self.combine:
            mc = dict(c.get("image_text_modal_combine") or {
                "type": "non_linear_element_multiply",
                "params": {"dropout": 0, "hidden_dim": cfg.hidden_size}})
            self.image_text_multi_modal_combine_layer = ModalCombineLayer(
                mc["type"], image_dim, text_dim,
                dict(mc.get("params") or {}))
            joint_dim = self.image_text_multi_modal_combine_layer.out_dim
        self.pooler = Pooler(cfg)
        # flax's Dense takes its input width from the joint stream
        self.pooler.dense = _dense(cfg, joint_dim, cfg.hidden_size)

        head = self.head
        if "pretraining" in head:
            self.cls = MLMHead(cfg)
            self.cls.transform.dense = _dense(cfg, joint_dim,
                                              cfg.hidden_size)
            self.seq_relationship = Dense(cfg.hidden_size, 2)
        elif "vqa" in head or head == "vizwiz":
            n = c.get("num_labels", 7371 if "vizwiz" in head else 3129)
            self._build_classifier(joint_dim, n)
        elif head in ("nlvr2", "visual_entailment", "classification"):
            if head == "classification":
                n = c.get("num_labels", None) or registry.get(
                    f"{self._datasets()[0]}_num_final_outputs",
                    no_warning=True) or 2
            else:
                n = c.get("num_labels",
                          3 if head == "visual_entailment" else 2)
            self._build_classifier(cfg.hidden_size, n)

    def _build_classifier(self, in_features: int, num_labels: int):
        self.dropout = Dropout(self.tcfg.hidden_dropout_prob)
        self.classifier_transform = PredictionHeadTransform(
            self.tcfg, in_features)
        self.classifier_logits = Dense(self.tcfg.hidden_size, num_labels)

    @classmethod
    def config_path(cls):
        return "configs/models/mmf_bert/defaults.yaml"

    def _tcfg(self) -> TransformerConfig:
        return TransformerConfig.from_dict({
            f.name: self.config.get(f.name)
            for f in dataclasses.fields(TransformerConfig)
            if self.config.get(f.name, None) is not None})

    def _image_total(self, sample_list, text_total):
        embeddings = []
        idx = 0
        while f"image_feature_{idx}" in sample_list:
            if idx >= len(self.encoder_names):
                raise ValueError(
                    f"the batch holds image_feature_{idx}, and the model was "
                    f"built for {len(self.encoder_names)} feature sets (the "
                    "first dataset's features)")
            encoded = getattr(self, self.encoder_names[idx])(
                sample_list[f"image_feature_{idx}"])
            encoded = self.image_feature_projection(encoded)
            if self.intra:
                encoded = self.image_feature_intra_attention(
                    encoded, encoded, encoded)
            for j in range(self.n_embeddings):
                embeddings.append(getattr(
                    self, f"image_feature_embeddings_{idx}_{j}")(
                        text_total, encoded, encoded))
            idx += 1
        if not embeddings:
            return text_total
        return torch.cat(embeddings, dim=1)

    def forward(self, sample_list: Dict[str, Any]):
        input_ids = sample_list["input_ids"]
        input_mask = sample_list.get("input_mask")
        if input_mask is None:
            input_mask = torch.ones_like(input_ids)
        emb = self.word_embedding(input_ids, sample_list.get("segment_ids"))
        text_total = emb
        if hasattr(self, "text_embedding"):
            text_total = self.text_embedding(
                emb, emb, emb, key_padding_mask=input_mask == 0)
        image_total = self._image_total(sample_list, text_total)
        joint = image_total
        if self.combine:
            joint = self.image_text_multi_modal_combine_layer(image_total,
                                                              text_total)
        pooled = self.pooler(joint)
        head = self.head
        if "pretraining" in head:
            logits = self.cls(joint)
            rel = self.seq_relationship(pooled)
            output = {"logits": logits, "seq_relationship_score": rel}
            labels = sample_list.get("lm_label_ids", None)
            if labels is not None:
                ds = sample_list.get("dataset_name", "unknown")
                dt = sample_list.get("dataset_type", "train")
                losses = {f"{ds}/{dt}/masked_lm_loss":
                          masked_lm_loss(logits, labels)}
                is_next = sample_list.get("is_correct", None)
                if is_next is not None:
                    losses[f"{ds}/{dt}/next_sentence_loss"] = \
                        -picked_log_prob(rel, is_next).mean()
                output["losses"] = losses
            return output
        if "vqa" in head or head == "vizwiz":
            # the joint stream at the second-last real token
            gi = input_mask.sum(dim=1).long() - 2
            x = torch.gather(joint, 1, gi.view(-1, 1, 1).expand(
                -1, 1, joint.shape[2]))[:, 0]
        elif head in ("nlvr2", "visual_entailment", "classification"):
            x = pooled
        else:
            return {}
        x = self.classifier_transform(self.dropout(x))
        return {"scores": self.classifier_logits(x)}
