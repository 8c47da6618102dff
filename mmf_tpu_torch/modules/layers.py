"""Classifier layers (the part of ``mmf_tpu/modules/layers.py`` that the
Hateful Memes baselines use).

``ClassifierLayer`` dispatches on the config's type: ``mlp``
(``MLPClassifier``: per layer Dense, BatchNorm with flax's semantics,
activation and dropout, then the output Dense), ``linear``, ``bert``
(``BertClassifierHead``: dropout, BERT's prediction-head transform, a
Dense) and ``weight_norm`` (two weight-normalised Dense layers around a
ReLU and dropout). ``logit``, ``triple_linear`` and ``language_decoder``
raise, naming their families. Module names mirror the flax scopes
(``module``, ``dense_0``, ``norm_0``, ``out``, ...), so
``params_from_jax`` maps a JAX init mechanically, ``batch_stats``
included.

flax infers a Dense layer's input width from its first input; here the
caller gives it (``in_features``, the width of what the classifier
reads). ``in_dim`` keeps its JAX meaning: the default hidden width of
the ``weight_norm`` head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from mmf_tpu_torch.modules.resnet import BatchNorm
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    PredictionHeadTransform,
    TransformerConfig,
)

_NOT_PORTED = {
    "logit": "LogitClassifier (the pythia family)",
    "triple_linear": "TripleLinear (the movie_mcan family)",
    "language_decoder": "LanguageDecoder (modules/decoders.py, BUTD)",
}


class MLPClassifier(nn.Module):
    def __init__(self, in_features: int, out_dim: int,
                 hidden_dim: Optional[int] = None, num_layers: int = 0,
                 dropout: float = 0.5, hidden_act: str = "relu",
                 batch_norm: bool = True):
        super().__init__()
        # flax's nn.gelu is the tanh form by default
        self.act = {"relu": F.relu,
                    "gelu": lambda x: F.gelu(x, approximate="tanh")}[
            hidden_act]
        self.num_layers = num_layers
        self.batch_norm = batch_norm
        hidden = hidden_dim or in_features
        width = in_features
        for i in range(num_layers):
            self.add_module(f"dense_{i}", Dense(width, hidden))
            if batch_norm:
                self.add_module(f"norm_{i}", BatchNorm(hidden))
            self.add_module(f"dropout_{i}", Dropout(dropout))
            width = hidden
        self.out = Dense(width, out_dim)

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if self.batch_norm:
                x = getattr(self, f"norm_{i}")(x)
            x = getattr(self, f"dropout_{i}")(self.act(x))
        return self.out(x)


class BertClassifierHead(nn.Module):
    """Dropout, then BERT's prediction-head transform (Dense, GELU,
    LayerNorm) at ``hidden_size``, then a Dense to ``out_dim``."""

    def __init__(self, in_features: int, out_dim: int,
                 hidden_size: int = 768, hidden_dropout_prob: float = 0.1):
        super().__init__()
        self.dropout = Dropout(hidden_dropout_prob)
        self.transform = PredictionHeadTransform(
            TransformerConfig(hidden_size=hidden_size), in_features)
        self.decoder = Dense(hidden_size, out_dim)

    def forward(self, x):
        return self.decoder(self.transform(self.dropout(x)))


class _WeightNormScale(nn.Module):
    """The scalar gain of one weight-normalised Dense (flax keeps it in
    the ``WeightNorm`` wrapper's scope; the Dense's own kernel and bias
    sit in the parent's)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))


def _weight_norm_dense(dense: Dense, gain: _WeightNormScale, x):
    """flax ``nn.WeightNorm(nn.Dense, feature_axes=None)``: the kernel
    over its Frobenius norm (eps 1e-12 under the root), times the
    scalar gain."""
    w = dense.weight
    w = w * torch.rsqrt((w * w).sum() + 1e-12) * gain.scale
    return F.linear(x, w, dense.bias)


class WeightNormClassifier(nn.Module):
    def __init__(self, in_features: int, out_dim: int, hidden_dim: int,
                 dropout: float):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, out_dim)
        self.fc1 = _WeightNormScale()
        self.fc2 = _WeightNormScale()
        self.dropout = Dropout(dropout)

    def forward(self, x):
        x = F.relu(_weight_norm_dense(self.Dense_0, self.fc1, x))
        return _weight_norm_dense(self.Dense_1, self.fc2, self.dropout(x))


class ClassifierLayer(nn.Module):
    """The dispatcher: ``classifier_type`` with its ``params``, reading
    ``in_features``-wide inputs (``in_dim`` when not given)."""

    def __init__(self, classifier_type: str, in_dim: int, out_dim: int,
                 params: Dict[str, Any] = None,
                 in_features: Optional[int] = None):
        super().__init__()
        p = dict(params or {})
        width = in_dim if in_features is None else in_features
        t = classifier_type
        if t == "weight_norm":
            self.module = WeightNormClassifier(
                width, out_dim, p.get("hidden_dim", in_dim),
                p.get("dropout", 0.0))
        elif t == "mlp":
            self.module = MLPClassifier(
                width, out_dim, p.get("hidden_dim"), p.get("num_layers", 0),
                p.get("dropout", 0.5), p.get("hidden_act", "relu"),
                p.get("batch_norm", True))
        elif t == "bert":
            self.module = BertClassifierHead(width, out_dim,
                                             p.get("hidden_size", 768))
        elif t == "linear":
            self.module = Dense(width, out_dim)
        elif t in _NOT_PORTED:
            raise NotImplementedError(
                f"classifier {t!r} needs {_NOT_PORTED[t]}, which is not "
                "ported yet")
        else:
            raise NotImplementedError(f"Unknown classifier type: {t}")

    def forward(self, x):
        return self.module(x)
