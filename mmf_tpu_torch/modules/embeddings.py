"""Text embeddings (the part of ``mmf_tpu/modules/embeddings.py`` that
the Hateful Memes baselines use).

``TextEmbedding`` dispatches on the config's type: ``identity``,
``vocab`` (``VocabEmbedding``, a trainable table; JAX does not load
pretrained vectors into it either) and ``torch`` (a bare table). The
other types (``projection``, ``bilstm``, ``attention``, ``mcan``, ``pre
extracted``) raise, naming the module they wait for. Module names mirror
the flax scopes (``module`` at each level), so ``params_from_jax`` maps
the table mechanically.
"""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from mmf_tpu_torch.modules.transformer import Embed

_NOT_PORTED = {
    "projection": "ProjectionEmbedding",
    "bilstm": "BiLSTMTextEmbedding",
    "attention": "AttentionTextEmbedding",
    "mcan": "SAEmbedding",
    "preextracted": "PreExtractedEmbedding",
}


class Identity(nn.Module):
    def forward(self, x, *args, **kwargs):
        return x


class VocabEmbedding(nn.Module):
    """A float32 token table of ``vocab_size`` rows: ids [..] -> [.., D]."""

    def __init__(self, embedding_dim: int, vocab_size: int = 30522):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.module = Embed(vocab_size, embedding_dim)

    def forward(self, x):
        return self.module(x.long())


class TextEmbedding(nn.Module):
    """The dispatcher: ``emb_type`` with its ``params``."""

    def __init__(self, emb_type: str, params: Dict[str, Any] = None):
        super().__init__()
        p = dict(params or {})
        self.emb_type = emb_type
        if emb_type == "identity":
            self.module = Identity()
        elif emb_type == "vocab":
            self.module = VocabEmbedding(p["embedding_dim"],
                                         p.get("vocab_size", 30522))
        elif emb_type == "torch":
            self.module = Embed(p["vocab_size"], p["embedding_dim"])
        elif emb_type in _NOT_PORTED:
            raise NotImplementedError(
                f"text embedding {emb_type!r} needs "
                f"{_NOT_PORTED[emb_type]}, which is not ported yet")
        else:
            raise NotImplementedError(
                f"Unknown question embedding '{emb_type}'")

    @property
    def out_dim(self):
        return getattr(self.module, "embedding_dim", None)

    def forward(self, x, *args, **kwargs):
        if self.emb_type == "torch":
            return self.module(x.long())
        return self.module(x)
