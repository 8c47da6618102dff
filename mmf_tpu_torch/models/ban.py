"""BAN: bilinear attention networks.

Port of ``mmf_tpu/models/ban.py``. The question's words (a 300-wide
table) run through ``BiLSTMTextEmbedding`` (a GRU of ``num_hidden``,
every step kept); ``BiAttention`` makes ``gamma`` bilinear attention
maps over regions x words (``k`` 3); for each glimpse a ``BCNet`` pools
the regions and words under its map and a ``FCNet`` projects the pooled
vector, which is added to every word's state; the words' states, summed,
go through the weight-normalised classifier (``2 * num_hidden`` hidden).

The vocabulary and the answers come from the registry under the first
dataset's name (``<dataset>_text_vocab_size``,
``<dataset>_num_final_outputs``), else the config's ``text_vocab_size``
(100000) and ``num_labels`` (3129), as in JAX. The regions' width is
``bilinear_attention.visual_feat_dim`` (2048; flax infers it). Each
BCNet's rates of dropout are ``layers.BCNET_DROPOUT`` (0.2 and 0.5), which
no config key reaches, in JAX too; the config's ``bc_net.dropout``,
``bc_net.h_out``, ``fc_net.dims``, ``classifier.hidden_size`` and
``text_embedding.vocab_size`` are read nowhere.
"""

from __future__ import annotations

from typing import Any, Dict

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.embeddings import BiLSTMTextEmbedding
from mmf_tpu_torch.modules.layers import (
    BCNet,
    BiAttention,
    FCNet,
    WeightNormClassifier,
)
from mmf_tpu_torch.modules.transformer import Embed

WORD_DIM = 300


def first_dataset(default: str) -> str:
    cfg = registry.get("config", no_warning=True)
    if cfg is not None and cfg.get("datasets", None):
        d = cfg["datasets"]
        return (d.split(",") if isinstance(d, str) else list(d))[0]
    return default


@registry.register_model("ban")
class BAN(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        te, ba = c["text_embedding"], c["bilinear_attention"]
        hidden = te["num_hidden"]
        self.gamma = ba["gamma"]
        dataset = first_dataset("vqa2")
        vocab_size = registry.get(dataset + "_text_vocab_size",
                                  no_warning=True) or c.get(
            "text_vocab_size", 100000)
        num_choices = registry.get(dataset + "_num_final_outputs",
                                   no_warning=True) or c.get(
            "num_labels", 3129)
        v_dim = ba.get("visual_feat_dim", 2048)
        self.word_embedding = Embed(vocab_size, WORD_DIM)
        self.q_emb = BiLSTMTextEmbedding(
            hidden, WORD_DIM, te.get("num_layers", 1),
            te.get("dropout", 0.0), te.get("bidirectional", False),
            te.get("rnn_type", "GRU"))
        q_dim = self.q_emb.out_dim
        self.v_att = BiAttention(v_dim, q_dim, hidden, self.gamma)
        fc = ba.get("fc_net", {}) or {}
        for g in range(self.gamma):
            self.add_module(f"b_net_{g}", BCNet(
                v_dim, q_dim, hidden, None,
                k=(ba.get("bc_net", {}) or {}).get("k", 1)))
            self.add_module(f"q_prj_{g}", FCNet(
                (hidden, hidden), act=fc.get("activation", "ReLU"),
                dropout=fc.get("dropout", 0.0)))
        self.classifier = WeightNormClassifier(
            q_dim, num_choices, hidden * 2,
            c["classifier"].get("dropout", 0.5))

    @classmethod
    def config_path(cls):
        return "configs/models/ban/defaults.yaml"

    def forward(self, sample_list: Dict[str, Any]):
        v = sample_list["image_feature_0"]
        q_emb = self.q_emb(self.word_embedding(sample_list["text"].long()),
                           forward_all=True)
        att, _ = self.v_att(v, q_emb)
        for g in range(self.gamma):
            b_emb = getattr(self, f"b_net_{g}")(v, q_emb, w=att[:, g])
            q_emb = getattr(self, f"q_prj_{g}")(b_emb[:, None]) + q_emb
        return {"scores": self.classifier(q_emb.sum(dim=1))}
