"""Text embeddings, top-down image-feature attention pooling and
``ImageFinetune``, the fc6 -> fc7 layer over region features.

``TextEmbedding`` dispatches on the config's type: ``identity``,
``vocab`` (``VocabEmbedding``, a trainable table; JAX does not load
pretrained vectors into it either), ``torch`` (a bare table),
``attention`` (``AttentionTextEmbedding``, Pythia's LSTM with
convolutional attention over the words), ``bilstm``
(``BiLSTMTextEmbedding``, BAN's GRU or LSTM over the words) and
``projection`` (``ProjectionEmbedding``, a ``linear`` layer or a stack
of ``conv`` layers). The other types (``mcan``, ``preextracted``) raise,
naming the module they wait for. ``ImageFeatureEmbedding`` is Pythia's
question-guided pooling of the regions, ``MultiHeadImageFeatureEmbedding``
the ``multihead`` model's multi-head attention from the question to the
regions. Module names mirror the flax scopes (``module`` at each level,
``lstm_0_fwd``, ``rnn_0_fwd``, ``conv1``), so ``params_from_jax`` maps
the weights mechanically.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmf_tpu_torch.modules.transformer import Dense, Dropout, Embed

_NOT_PORTED = {
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
        elif emb_type == "attention":
            self.module = AttentionTextEmbedding(
                p["hidden_dim"], p["embedding_dim"], p.get("num_layers", 1),
                p.get("dropout", 0.0), p.get("conv1_out", 512),
                p.get("conv2_out", 2), p.get("kernel_size", 1),
                p.get("padding", 0), p.get("bidirectional", False))
        elif emb_type == "bilstm":
            self.module = BiLSTMTextEmbedding(
                p["hidden_dim"], p["embedding_dim"], p.get("num_layers", 1),
                p.get("dropout", 0.0), p.get("bidirectional", False),
                p.get("rnn_type", "GRU"))
        elif emb_type == "projection":
            self.module = ProjectionEmbedding(
                p.get("module", "linear"), p.get("in_dim"), p.get("out_dim"),
                p.get("convs"))
        elif emb_type in _NOT_PORTED:
            raise NotImplementedError(
                f"text embedding {emb_type!r} needs "
                f"{_NOT_PORTED[emb_type]}, which is not ported yet")
        else:
            raise NotImplementedError(
                f"Unknown question embedding '{emb_type}'")

    @property
    def out_dim(self):
        if self.emb_type == "attention":
            return self.module.text_out_dim
        if self.emb_type in ("projection", "bilstm"):
            return self.module.out_dim
        return getattr(self.module, "embedding_dim", None)

    def forward(self, x, *args, **kwargs):
        if self.emb_type == "torch":
            return self.module(x.long())
        return self.module(x)


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over the one axis between batch and channels,
    [B, T, in] -> [B, T', out], padded ``padding`` on both sides. The
    kernel stays in flax's [W, in, out] layout (``weight``), which JAX's
    ``convert_torch_state_dict`` takes back as it is."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int = 1, padding: int = 0):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(kernel_size, in_features,
                                               out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        if self.weight.shape[0] == 1 and self.padding == 0:
            return F.linear(x, self.weight[0].t(), self.bias)
        return F.conv1d(x.transpose(1, 2), self.weight.permute(2, 1, 0),
                        self.bias, padding=self.padding).transpose(1, 2)


class ProjectionEmbedding(nn.Module):
    """A ``linear`` layer (``layers``) from ``in_dim`` to ``out_dim``, or
    a stack of ``conv`` layers (``conv_<i>``, flax ``nn.Conv`` over the
    axis between batch and channels: ``out_channels`` and
    ``kernel_size`` from each of ``convs``, padded as flax's default
    ``SAME``, no activation between them; each takes the width the one
    before gives, the first ``in_dim``)."""

    def __init__(self, module: str, in_dim: int, out_dim: int,
                 convs: Optional[Any] = None):
        super().__init__()
        self.kind = module
        if module == "linear":
            self.layers = Dense(in_dim, out_dim)
            self.out_dim = out_dim
        elif module == "conv":
            self.n_convs = len(convs or [])
            width = in_dim
            for i, conv in enumerate(convs or []):
                self.add_module(f"conv_{i}", Conv1d(
                    width, conv["out_channels"], conv.get("kernel_size", 1)))
                width = conv["out_channels"]
            self.out_dim = width
        else:
            raise TypeError("Unknown module type for 'ProjectionEmbedding', "
                            "use 'linear' or 'conv'")

    def forward(self, x):
        if self.kind == "linear":
            return self.layers(x)
        for i in range(self.n_convs):
            conv = getattr(self, f"conv_{i}")
            width = conv.weight.shape[0]  # SAME: (w - 1) // 2 before
            x = conv(F.pad(x, (0, 0, (width - 1) // 2, width // 2)))
        return x


class BiLSTMTextEmbedding(nn.Module):
    """BAN's question encoder (``mmf_tpu/modules/embeddings.py:59``):
    ``num_layers`` recurrent layers (``rnn_type`` ``GRU``, flax's
    ``GRUCell``, or ``LSTM``, its ``OptimizedLSTMCell``) named
    ``rnn_<layer>_fwd``, and ``rnn_<layer>_bwd`` run backwards in time
    when bidirectional (``hidden_dim / 2`` each, concatenated), over every
    step of the padded length, as ``nn.RNN`` runs without
    ``seq_lengths``. ``forward_all`` returns every step [B, T, H], else
    the last step's [B, H], bidirectional or not, as JAX does. The rate
    of ``dropout`` is read nowhere, in JAX too."""

    def __init__(self, hidden_dim: int, embedding_dim: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 bidirectional: bool = False, rnn_type: str = "GRU"):
        super().__init__()
        from mmf_tpu_torch.modules.layers import GRUCell, LSTMCell

        cell = {"LSTM": LSTMCell, "GRU": GRUCell}[rnn_type]
        self.bidirectional = bidirectional
        self.num_layers = num_layers
        hid = hidden_dim // (2 if bidirectional else 1)
        width = embedding_dim
        for i in range(num_layers):
            self.add_module(f"rnn_{i}_fwd", cell(width, hid))
            if bidirectional:
                self.add_module(f"rnn_{i}_bwd", cell(width, hid))
            width = 2 * hid if bidirectional else hid
        self.out_dim = width

    def forward(self, x, forward_all: bool = False):
        from mmf_tpu_torch.modules.layers import run_rnn

        out = x
        for i in range(self.num_layers):
            fwd = run_rnn(getattr(self, f"rnn_{i}_fwd"), out)
            if self.bidirectional:
                bwd = run_rnn(getattr(self, f"rnn_{i}_bwd"), out, True)
                fwd = torch.cat([fwd, bwd], dim=-1)
            out = fwd
        return out if forward_all else out[:, -1]


class AttentionTextEmbedding(nn.Module):
    """An LSTM over the words (flax ``nn.RNN`` over an
    ``OptimizedLSTMCell`` named ``lstm_<layer>_fwd``, and ``_bwd`` run
    backwards in time when bidirectional), dropout, then two
    convolutions over time (``conv1``, ReLU, ``conv2``: ``conv2_out``
    attention maps), a softmax over time and the maps' weighted sums of
    the LSTM's outputs, flattened: [B, T, E] -> [B, conv2_out * H]."""

    def __init__(self, hidden_dim: int, embedding_dim: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 conv1_out: int = 512, conv2_out: int = 2,
                 kernel_size: int = 1, padding: int = 0,
                 bidirectional: bool = False):
        super().__init__()
        from mmf_tpu_torch.modules.layers import LSTMCell

        self.bidirectional = bidirectional
        self.num_layers = num_layers
        self.text_out_dim = hidden_dim * conv2_out
        hid = hidden_dim // 2 if bidirectional else hidden_dim
        width = embedding_dim
        for i in range(num_layers):
            self.add_module(f"lstm_{i}_fwd", LSTMCell(width, hid))
            if bidirectional:
                self.add_module(f"lstm_{i}_bwd", LSTMCell(width, hid))
            width = 2 * hid if bidirectional else hid
        self.dropout = Dropout(dropout)
        self.conv1 = Conv1d(width, conv1_out, kernel_size, padding)
        self.conv2 = Conv1d(conv1_out, conv2_out, kernel_size, padding)

    def forward(self, x):
        from mmf_tpu_torch.modules.layers import run_rnn

        out = x
        for i in range(self.num_layers):
            fwd = run_rnn(getattr(self, f"lstm_{i}_fwd"), out)
            if self.bidirectional:
                bwd = run_rnn(getattr(self, f"lstm_{i}_bwd"), out, True)
                fwd = torch.cat([fwd, bwd], dim=-1)
            out = fwd
        lstm_drop = self.dropout(out)  # [B, T, H]
        h = F.relu(self.conv1(lstm_drop))
        attn = torch.softmax(self.conv2(h), dim=1)  # [B, T, A]
        feat = torch.bmm(attn.transpose(1, 2), lstm_drop)  # [B, A, H]
        return feat.reshape(x.shape[0], -1)


class ImageFeatureEmbedding(nn.Module):
    """Top-down attention pooling of the regions
    (``mmf_tpu/modules/embeddings.py:230``): the attention
    (``image_attention_model``, [B, K, A]) weighs the regions (with
    ``order_vectors`` appended when ``extra`` has them) into A pooled
    features, flattened. Returns (pooled, attention)."""

    def __init__(self, img_dim: int, question_dim: int,
                 modal_combine: Dict[str, Any], transform: Dict[str, Any],
                 normalization: str = "softmax"):
        super().__init__()
        from mmf_tpu_torch.modules.attention import AttentionLayer

        self.image_attention_model = AttentionLayer(
            img_dim, question_dim, modal_combine, transform, normalization)

    def forward(self, image_feat, question_embedding, image_dims,
                extra: Optional[Dict[str, Any]] = None):
        attention = self.image_attention_model(
            image_feat, question_embedding, image_dims)
        order_vectors = (extra or {}).get("order_vectors", None)
        if order_vectors is not None:
            image_feat = torch.cat([image_feat, order_vectors], dim=-1)
        pooled = torch.bmm(attention.transpose(1, 2), image_feat)
        return pooled.reshape(pooled.shape[0], -1), attention


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


class MultiHeadImageFeatureEmbedding(nn.Module):
    """The ``multihead`` model's attention from the question to the
    regions (``mmf_tpu/modules/embeddings.py:259``): ``q_proj`` of the
    question [B, question_dim] as one query row, ``k_proj`` and ``v_proj``
    of the regions [B, K, img_dim], ``num_heads`` heads of
    ``question_dim / num_heads`` (256 at Pythia's 2048-wide question and 8
    heads), no mask (``image_dims`` is unread, as in JAX), ``out_proj``.
    The attention is ``dot_product_attention``: the kernels on the card.
    Returns (the [B, question_dim] output, None)."""

    def __init__(self, img_dim: int, question_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.out_dim = question_dim
        self.q_proj = Dense(question_dim, question_dim)
        self.k_proj = Dense(img_dim, question_dim)
        self.v_proj = Dense(img_dim, question_dim)
        self.out_proj = Dense(question_dim, question_dim)

    def forward(self, image_feat, question_embedding, image_dims=None,
                extra: Optional[Dict[str, Any]] = None):
        from mmf_tpu_torch.ops.attention import dot_product_attention

        b, h = image_feat.shape[0], self.num_heads

        def split(t):
            return t.reshape(b, t.shape[1], h, -1).transpose(1, 2)

        ctx = dot_product_attention(
            split(self.q_proj(question_embedding[:, None, :])),
            split(self.k_proj(image_feat)), split(self.v_proj(image_feat)))
        out = self.out_proj(ctx.transpose(1, 2).reshape(b, 1, -1))
        return out[:, 0], None
