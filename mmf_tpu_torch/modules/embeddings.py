"""Text embeddings (the part of ``mmf_tpu/modules/embeddings.py`` that
the Hateful Memes baselines use) and ``ImageFinetune``, M4C's fc6 -> fc7
layer over region features.

``TextEmbedding`` dispatches on the config's type: ``identity``,
``vocab`` (``VocabEmbedding``, a trainable table; JAX does not load
pretrained vectors into it either) and ``torch`` (a bare table). The
other types (``projection``, ``bilstm``, ``attention``, ``mcan``, ``pre
extracted``) raise, naming the module they wait for. Module names mirror
the flax scopes (``module`` at each level), so ``params_from_jax`` maps
the table mechanically.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmf_tpu_torch.modules.transformer import Dense, Embed

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


class ImageFinetune(nn.Module):
    """fc6 -> fc7 over region features: ``relu(lc(x))`` (reference
    embeddings.py:289-306). With ``weights_file`` and ``bias_file``
    (pickled numpy arrays, weights [out, in]) the layer takes its width
    and values from them, at construction and again whenever
    ``BaseModel.init_weights`` has drawn the model's weights; without
    them it is ``out_dim_hint`` wide and drawn with the rest."""

    def __init__(self, in_dim: int, weights_file: Optional[str] = None,
                 bias_file: Optional[str] = None, out_dim_hint: int = 2048):
        super().__init__()
        self.pretrained = None
        out_dim = out_dim_hint
        if weights_file and os.path.exists(weights_file):
            with open(weights_file, "rb") as w:
                weights = np.asarray(pickle.load(w), np.float32)
            with open(bias_file, "rb") as b:
                bias = np.asarray(pickle.load(b), np.float32)
            out_dim = bias.shape[0]
            self.pretrained = (torch.from_numpy(weights),
                               torch.from_numpy(bias))
        self.out_dim = out_dim
        self.lc = Dense(in_dim, out_dim)
        self.load_pretrained()

    @torch.no_grad()
    def load_pretrained(self):
        """Copy the pickled weights into ``lc`` (nothing without them)."""
        if self.pretrained is not None:
            self.lc.weight.copy_(self.pretrained[0])
            self.lc.bias.copy_(self.pretrained[1])

    def forward(self, image):
        return F.relu(self.lc(image))
