"""Layers of ``mmf_tpu/modules/layers.py``: the classifiers, the
weight-normalised products, the LSTM cell and the Pythia / BUTD combine
and transform layers.

``ClassifierLayer`` dispatches on the config's type: ``mlp``
(``MLPClassifier``: per layer Dense, BatchNorm with flax's semantics,
activation and dropout, then the output Dense), ``linear``, ``bert``
(``BertClassifierHead``: dropout, BERT's prediction-head transform, a
Dense), ``weight_norm`` (two weight-normalised Dense layers around a
ReLU and dropout), ``logit`` (Pythia's two-branch head) and
``language_decoder`` (BUTD's, ``modules/decoders.py``).
``triple_linear`` raises, naming its family. Module names mirror the
flax scopes (``module``, ``dense_0``, ``norm_0``, ``out``, ...), so
``params_from_jax`` maps a JAX init mechanically, ``batch_stats``
included: a ``wn_dense`` is two modules, the gain under its name and the
Dense as the parent's ``Dense_<n>`` (``add_wn_dense``), an LSTM cell
keeps flax's eight products (``ii`` ... ``ho``) and a GRU cell its six
(``ir`` ... ``hn``). ``run_rnn`` is flax's ``nn.RNN`` over either cell.
BAN's blocks are here too: ``FCNet`` (weight-normalised Dense layers),
``BCNet`` (the bilinear connection, in its three forms) and
``BiAttention``; and CNN-LSTM's ``ConvNet`` (conv, leaky ReLU, max pool,
BatchNorm).

flax infers a Dense layer's input width from its first input; here the
caller gives it (``in_features``, the width of what the classifier
reads), or leaves it to the first input (``in_features=None`` with
``in_dim=None``: the ``mlp`` head's first Dense is a ``LazyDense``).
``in_dim`` keeps its JAX meaning: the default hidden width of the
``weight_norm`` head.
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
    LazyDense,
    PredictionHeadTransform,
    TransformerConfig,
)

_NOT_PORTED = {
    "triple_linear": "TripleLinear (the movie_mcan family)",
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

        def dense(out):  # the first takes its width from its input
            return LazyDense(out) if width is None else Dense(width, out)

        for i in range(num_layers):
            self.add_module(f"dense_{i}", dense(hidden))
            if batch_norm:
                self.add_module(f"norm_{i}", BatchNorm(hidden))
            self.add_module(f"dropout_{i}", Dropout(dropout))
            width = hidden
        self.out = dense(out_dim)

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


class WeightNormGain(nn.Module):
    """The gain of one flax ``nn.WeightNorm(nn.Dense)``. flax keeps it in
    the wrapper's scope under the wrapped kernel's name
    (``fc1/{Dense_0/kernel/scale}``) and the Dense's own kernel and bias
    in the parent's (``Dense_0``): the parameter here carries that name,
    so the port's ``state_dict`` key (``fc1.Dense_0/kernel/scale``) is
    flax's path with dots. ``features=None`` is one gain for the whole
    kernel (``feature_axes=None``), else one an output
    (``feature_axes=-1``)."""

    def __init__(self, dense_name: str, features: Optional[int] = None):
        super().__init__()
        self.key = f"{dense_name}/kernel/scale"
        shape = () if features is None else (features,)
        self.register_parameter(self.key, nn.Parameter(torch.ones(shape)))

    @property
    def scale(self) -> torch.Tensor:
        return getattr(self, self.key)


def weight_norm_weight(dense: Dense, gain: WeightNormGain) -> torch.Tensor:
    """flax ``WeightNorm``'s kernel: over its L2 norm (eps 1e-12 under the
    root), the whole kernel's or each output's, times the gain."""
    w = dense.weight
    if gain.scale.dim() == 0:
        return w * torch.rsqrt((w * w).sum() + 1e-12) * gain.scale
    return (w * torch.rsqrt((w * w).sum(1, keepdim=True) + 1e-12)
            * gain.scale[:, None])


def weight_norm_dense(dense: Dense, gain: WeightNormGain, x):
    """``wn_dense``: the weight-normalised Dense applied to ``x``."""
    return F.linear(x, weight_norm_weight(dense, gain), dense.bias)


def add_wn_dense(parent: nn.Module, name: str, index: int, in_features: int,
                 out_features: int, per_output: bool = False):
    """Give ``parent`` the two modules of flax's ``wn_dense(out, name)``
    made as the parent's ``index``-th unnamed Dense: the gain ``name``
    and the Dense ``Dense_<index>``."""
    dense = f"Dense_{index}"
    parent.add_module(name, WeightNormGain(
        dense, out_features if per_output else None))
    parent.add_module(dense, Dense(in_features, out_features))


def apply_wn_dense(parent: nn.Module, name: str, x):
    gain = getattr(parent, name)
    return weight_norm_dense(getattr(parent, gain.key.split("/")[0]), gain, x)


class WeightNormClassifier(nn.Module):
    def __init__(self, in_features: int, out_dim: int, hidden_dim: int,
                 dropout: float):
        super().__init__()
        add_wn_dense(self, "fc1", 0, in_features, hidden_dim)
        add_wn_dense(self, "fc2", 1, hidden_dim, out_dim)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        x = F.relu(apply_wn_dense(self, "fc1", x))
        return apply_wn_dense(self, "fc2", self.dropout(x))


class ReLUWithWeightNormFC(nn.Module):
    """``relu(wn_dense(x))``, the gain ``fc`` over ``Dense_0``."""

    def __init__(self, in_features: int, out_dim: int):
        super().__init__()
        add_wn_dense(self, "fc", 0, in_features, out_dim)

    def forward(self, x):
        return F.relu(apply_wn_dense(self, "fc", x))


class LogitClassifier(nn.Module):
    """Pythia's two-branch head: ``linear_text(f_o_text(x)) +
    linear_image(f_o_image(x))``; ``branch="text"`` scores the text
    branch alone (``pythia_question_only``)."""

    def __init__(self, in_features: int, out_dim: int, text_hidden_dim: int,
                 img_hidden_dim: int, text_only: bool = False):
        super().__init__()
        self.f_o_text = ReLUWithWeightNormFC(in_features, text_hidden_dim)
        self.linear_text = Dense(text_hidden_dim, out_dim)
        if not text_only:  # flax builds what is called
            self.f_o_image = ReLUWithWeightNormFC(in_features,
                                                  img_hidden_dim)
            self.linear_image = Dense(img_hidden_dim, out_dim)

    def forward(self, x, branch: Optional[str] = None):
        text = self.linear_text(self.f_o_text(x))
        if branch == "text":
            return text
        return text + self.linear_image(self.f_o_image(x))


GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell``: the input products ``ii``, ``if``,
    ``ig``, ``io`` without a bias, the hidden products ``hi``, ``hf``,
    ``hg``, ``ho`` with the one bias a gate; gates in the order i, f, g, o
    (sigmoid, sigmoid, tanh, sigmoid); ``c' = f c + i g``, ``h' = o
    tanh(c')``; the carry is ``(c, h)``. The four products of each kind
    run as one, on the gates' weights concatenated (``fused``), which a
    decode loop takes once and passes to every step."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        for g in GATES:
            self.add_module(f"i{g}", Dense(in_features, features, bias=False))
            self.add_module(f"h{g}", Dense(features, features))

    def fused(self):
        """(input weight [4H, in], hidden weight [4H, H], bias [4H])."""
        def cat(kind, leaf):
            return torch.cat([getattr(getattr(self, kind + g), leaf)
                              for g in GATES])
        return cat("i", "weight"), cat("h", "weight"), cat("h", "bias")

    def forward(self, carry, x, fused=None):
        c, h = carry
        wi, wh, bh = self.fused() if fused is None else fused
        y = F.linear(h, wh, bh) + F.linear(x, wi)
        i, f, g, o = y.split(self.features, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def zero_carry(self, x):
        zeros = x.new_zeros(x.shape[0], self.features)
        return zeros, zeros

    def prepare(self, xs):
        """What ``run_rnn`` hands each step: the inputs as they are, and
        the fused weights."""
        return xs, self.fused()


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: the input products ``ir``, ``iz``, ``in`` with
    a bias, the hidden products ``hr`` and ``hz`` without one and ``hn``
    with one; ``r = sigmoid(ir x + hr h)``, ``z = sigmoid(iz x + hz h)``,
    ``n = tanh(in x + r hn h)``, ``h' = (1 - z) n + z h``; the carry is
    ``h``. ``prepare`` runs the three input products over the whole
    sequence at once; each step then makes one product of ``h`` with the
    hidden weights concatenated (the bias of ``hr`` and ``hz`` is a zero
    row, which adds nothing)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        for g in "rzn":
            self.add_module(f"i{g}", Dense(in_features, features))
        self.hr = Dense(features, features, bias=False)
        self.hz = Dense(features, features, bias=False)
        self.hn = Dense(features, features)

    def zero_carry(self, x):
        return x.new_zeros(x.shape[0], self.features)

    def prepare(self, xs):
        """(the input products of ``xs`` [B, T, in] -> [B, T, 3H], the
        hidden weight [3H, H] and bias [3H])."""
        wi = torch.cat([self.ir.weight, self.iz.weight, self.in_.weight])
        bi = torch.cat([self.ir.bias, self.iz.bias, self.in_.bias])
        wh = torch.cat([self.hr.weight, self.hz.weight, self.hn.weight])
        bh = torch.cat([torch.zeros_like(self.hn.bias).repeat(2),
                        self.hn.bias])
        return F.linear(xs, wi, bi), (wh, bh)

    @property
    def in_(self):  # ``in`` is a Python keyword
        return getattr(self, "in")

    def forward(self, h, xp, weights):
        """One step: ``xp`` is this step's row of ``prepare``'s input
        products."""
        xr, xz, xn = xp.split(self.features, dim=-1)
        hr, hz, hn = F.linear(h, *weights).split(self.features, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        return h, h


def run_rnn(cell, xs, reverse: bool = False):
    """flax ``nn.RNN(cell)`` over ``xs`` [B, T, in] from a zero carry:
    every step of the padded length (no ``seq_lengths``); ``reverse``
    walks from the last step to the first and keeps the outputs in the
    inputs' order (``reverse=True, keep_order=True``). [B, T, H]."""
    inputs, weights = cell.prepare(xs)
    carry, outs = cell.zero_carry(xs), []
    steps = range(xs.shape[1] - 1, -1, -1) if reverse else range(
        xs.shape[1])
    for t in steps:
        carry, h = cell(carry, inputs[:, t], weights)
        outs.append(h)
    if reverse:
        outs.reverse()
    return torch.stack(outs, dim=1)


class TopDownAttentionLSTM(nn.Module):
    """BUTD's attention LSTM (``mmf_tpu/modules/layers.py:404``): an LSTM
    over ``[h2, mean of the regions, the word]``, then ``relu(fa_image(
    regions) + fa_hidden(h1))`` and dropout. ``fa_image`` and
    ``fa_hidden`` are weight-normalised with a gain an output. The state
    is threaded explicitly: ``{"td_hidden": (h1, c1), "lm_hidden": (h2,
    c2)}``. A decode loop computes the step-invariant parts once
    (``prepare``): the regions' projection and their mean do not change
    between steps, and the dropout comes after the sum, so the values are
    the same as recomputing them at every step."""

    def __init__(self, image_dim: int, embedding_dim: int,
                 attention_dim: int, hidden_dim: int, dropout: float):
        super().__init__()
        self.top_down_lstm = LSTMCell(hidden_dim + image_dim + embedding_dim,
                                      hidden_dim)
        add_wn_dense(self, "fa_image", 0, image_dim, attention_dim, True)
        add_wn_dense(self, "fa_hidden", 1, hidden_dim, attention_dim, True)
        self.dropout = Dropout(dropout)

    def prepare(self, image_feat):
        """What every step shares: (regions' mean, fa_image(regions), the
        LSTM's and fa_hidden's weights)."""
        return (image_feat.mean(dim=1), apply_wn_dense(self, "fa_image",
                                                       image_feat),
                self.top_down_lstm.fused(),
                weight_norm_weight(self.Dense_1, self.fa_hidden))

    def forward(self, image_feat, embedding, state, prepared=None):
        image_mean, image_fa, lstm_w, hidden_w = (
            self.prepare(image_feat) if prepared is None else prepared)
        (h1, c1), (h2, _) = state["td_hidden"], state["lm_hidden"]
        (c1, h1), _ = self.top_down_lstm(
            (c1, h1), torch.cat([h2, image_mean, embedding], dim=1), lstm_w)
        new_state = dict(state)
        new_state["td_hidden"] = (h1, c1)
        hidden_fa = F.linear(h1, hidden_w, self.Dense_1.bias)
        joint = F.relu(image_fa + hidden_fa[:, None, :])
        return self.dropout(joint), new_state


class NonLinearElementMultiply(nn.Module):
    """``dropout(fa_image(i) * fa_txt(t))`` with ReLU'd weight-normalised
    arms (``mmf_tpu/modules/layers.py:369``); ``branch`` keeps one arm,
    built and called alone (the ``pythia_question_only`` /
    ``pythia_image_only`` ablations). ``context_dim`` adds the
    ``fa_context`` arm (LoRRA's): ``fa_context(c) * fa_txt(t)`` is
    concatenated to the image's product, twice as wide."""

    def __init__(self, image_dim: int, text_dim: int, hidden_dim: int,
                 dropout: float, context_dim: Optional[int] = None,
                 branch: Optional[str] = None):
        super().__init__()
        # flax builds the arms that are called
        if branch != "text":
            self.fa_image = ReLUWithWeightNormFC(image_dim, hidden_dim)
        if branch != "image":
            self.fa_txt = ReLUWithWeightNormFC(text_dim, hidden_dim)
        if context_dim is not None:
            self.fa_context = ReLUWithWeightNormFC(context_dim, hidden_dim)
        self.dropout = Dropout(dropout)
        # the context's product is concatenated to the image's
        self.out_dim = hidden_dim * (1 if context_dim is None else 2)

    def forward(self, image_feat, question_embedding, context_embedding=None,
                branch: Optional[str] = None):
        if branch == "text":
            return self.dropout(self.fa_txt(question_embedding))
        if branch == "image":
            return self.dropout(self.fa_image(image_feat))
        image_fa = self.fa_image(image_feat)
        question_fa = self.fa_txt(question_embedding)
        if image_feat.dim() == 3 and question_fa.dim() != 3:
            question_fa = question_fa[:, None, :]
        joint = image_fa * question_fa
        if context_embedding is not None:
            context_fa = self.fa_context(context_embedding)
            joint = torch.cat([joint, context_fa * question_fa], dim=1)
        return self.dropout(joint)


# the combine types the ported families use; the others name theirs
_COMBINE_NOT_PORTED = {
    "MFH": "MFHCombine (the pythia multihead / movie_mcan families)",
    "two_layer_element_multiply": "TwoLayerElementMultiply",
    "top_down_attention_lstm": "TopDownAttentionLSTM through the combine "
                               "dispatcher (BUTD builds it directly)",
}


class ModalCombineLayer(nn.Module):
    """The dispatcher (``mmf_tpu/modules/layers.py:636``) for
    ``non_linear_element_multiply``."""

    def __init__(self, combine_type: str, image_dim: int, text_dim: int,
                 params: Dict[str, Any] = None, branch: Optional[str] = None):
        super().__init__()
        p = dict(params or {})
        if combine_type == "non_linear_element_multiply":
            self.module = NonLinearElementMultiply(
                image_dim, text_dim, p["hidden_dim"], p.get("dropout", 0.0),
                p.get("context_dim"), branch)
        elif combine_type in _COMBINE_NOT_PORTED:
            raise NotImplementedError(
                f"combine type {combine_type!r} needs "
                f"{_COMBINE_NOT_PORTED[combine_type]}, which is not ported "
                "yet")
        else:
            raise NotImplementedError(
                f"Not implemented combine type: {combine_type}")
        self.out_dim = self.module.out_dim

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)


class LinearTransform(nn.Module):
    """``wn_dense(out_dim, name="lc")``, one gain for the kernel."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        add_wn_dense(self, "lc", 0, in_dim, out_dim)

    def forward(self, x):
        return apply_wn_dense(self, "lc", x)


class TransformLayer(nn.Module):
    def __init__(self, transform_type: str, in_dim: int, out_dim: int,
                 hidden_dim: Optional[int] = None):
        super().__init__()
        if transform_type == "linear":
            self.module = LinearTransform(in_dim, out_dim)
        elif transform_type == "conv":
            raise NotImplementedError(
                "transform 'conv' needs ConvTransform, which is not ported "
                "yet")
        else:
            raise NotImplementedError(
                f"Unknown post combine transform type: {transform_type}")

    def forward(self, x):
        return self.module(x)


class ClassifierLayer(nn.Module):
    """The dispatcher: ``classifier_type`` with its ``params``, reading
    ``in_features``-wide inputs (``in_dim`` when not given);
    ``branch="text"`` builds the ``logit`` head's text branch alone."""

    def __init__(self, classifier_type: str, in_dim: int, out_dim: int,
                 params: Dict[str, Any] = None,
                 in_features: Optional[int] = None,
                 branch: Optional[str] = None):
        super().__init__()
        p = dict(params or {})
        width = in_dim if in_features is None else in_features
        t = classifier_type
        if width is None and t != "mlp":
            raise ValueError(f"classifier {t!r} needs its input width")
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
        elif t == "logit":
            self.module = LogitClassifier(
                width, out_dim, p.get("text_hidden_dim", in_dim),
                p.get("img_hidden_dim", in_dim), branch == "text")
        elif t == "language_decoder":
            from mmf_tpu_torch.modules.decoders import LanguageDecoder

            self.module = LanguageDecoder(width, out_dim, **{
                k: v for k, v in p.items()
                if k in ("hidden_dim", "dropout", "fc_bias_init")})
        elif t in _NOT_PORTED:
            raise NotImplementedError(
                f"classifier {t!r} needs {_NOT_PORTED[t]}, which is not "
                "ported yet")
        else:
            raise NotImplementedError(f"Unknown classifier type: {t}")

    def forward(self, x, *args, **kwargs):
        return self.module(x, *args, **kwargs)


_ACTIVATIONS = {"ReLU": F.relu, "relu": F.relu, None: lambda x: x}


class FCNet(nn.Module):
    """BAN's stack of weight-normalised Dense layers
    (``mmf_tpu/modules/layers.py:99``): for each step of ``dims``,
    dropout, ``wn_dense`` (the gain ``fc_<i>`` over ``Dense_<i>``, one
    gain a kernel) and the activation."""

    def __init__(self, dims, act: Optional[str] = "ReLU",
                 dropout: float = 0.0):
        super().__init__()
        self.act = _ACTIVATIONS[act]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            add_wn_dense(self, f"fc_{i}", i, dims[i], dims[i + 1])
        self.dropout = Dropout(dropout)

    def forward(self, x):
        for i in range(self.n_layers):
            x = self.act(apply_wn_dense(self, f"fc_{i}", self.dropout(x)))
        return x


# the rates BCNet takes when it is given none (FCNet's, then the one
# before the bilinear product), as in JAX; no config key reaches them
BCNET_DROPOUT = (0.2, 0.5)


class BCNet(nn.Module):
    """BAN's bilinear connection (``mmf_tpu/modules/layers.py:478``) of
    regions ``v`` [B, V, v_dim] and words ``q`` [B, Q, q_dim], each
    through an ``FCNet`` to ``h_dim * k``:

    - given ``w`` [B, V, Q] (``forward_with_weights``): the bilinear
      pooling sum_ij v'_bi w_bij q'_bj, its ``k`` slices averaged and
      scaled by ``k``: [B, h_dim];
    - ``h_out`` None: the products [B, V, Q, h_dim * k];
    - ``h_out`` <= 32: ``h_out`` maps through the learned ``h_mat`` and
      ``h_bias``, [B, h_out, V, Q]: the regions times ``h_mat`` are one
      [B, h_out, V, h_dim * k] tensor (3.1 GB in f32 at BAN's B = 512),
      as in JAX;
    - ``h_out`` > 32: the products through ``wn_dense`` ``h_net`` (over
      ``Dense_0``), [B, h_out, V, Q]."""

    C = 32

    def __init__(self, v_dim: int, q_dim: int, h_dim: int,
                 h_out: Optional[int], act: str = "ReLU",
                 dropout: Optional[Any] = None, k: int = 3):
        super().__init__()
        dropout = list(dropout or BCNET_DROPOUT)
        self.k, self.h_out = k, h_out
        self.v_net = FCNet((v_dim, h_dim * k), act, dropout[0])
        self.q_net = FCNet((q_dim, h_dim * k), act, dropout[0])
        self.dropout = Dropout(dropout[1])
        if h_out is not None and h_out <= self.C:
            self.h_mat = nn.Parameter(torch.zeros(1, h_out, 1, h_dim * k))
            self.h_bias = nn.Parameter(torch.zeros(1, h_out, 1, 1))
        elif h_out is not None:
            add_wn_dense(self, "h_net", 0, h_dim * k, h_out)

    def init_params(self, normal):
        """flax's ``normal(1.0)`` for ``h_mat`` and ``h_bias``."""
        if self.h_out is not None and self.h_out <= self.C:
            normal(self.h_mat, 1.0)
            normal(self.h_bias, 1.0)

    def forward(self, v, q, w=None):
        v_, q_ = self.v_net(v), self.q_net(q)
        if w is not None:
            logits = torch.einsum("bvk,bvq,bqk->bk", v_, w, q_)
            if self.k > 1:
                logits = logits.reshape(logits.shape[0], -1, self.k).mean(
                    -1) * self.k
            return logits
        if self.h_out is None:
            return torch.einsum("bvk,bqk->bvqk", v_, q_)
        v_d = self.dropout(v_)
        if self.h_out <= self.C:
            logits = torch.einsum("bgvk,bqk->bgvq", v_d[:, None] * self.h_mat,
                                  q_)
            return logits + self.h_bias
        d = torch.einsum("bvk,bqk->bvqk", v_d, q_)
        return apply_wn_dense(self, "h_net", d).permute(0, 3, 1, 2)


class BiAttention(nn.Module):
    """BAN's bilinear attention maps (``mmf_tpu/modules/layers.py:525``):
    a ``BCNet`` named ``logits`` with ``k`` 3 and ``glimpse`` maps, the
    regions whose features are all zero set to -inf, then a softmax over
    each map's V x Q entries. Returns (maps [B, glimpse, V, Q], the
    masked logits)."""

    def __init__(self, v_dim: int, q_dim: int, z_dim: int, glimpse: int,
                 dropout: Optional[Any] = None):
        super().__init__()
        self.glimpse = glimpse
        self.logits = BCNet(v_dim, q_dim, z_dim, glimpse, dropout=dropout,
                            k=3)

    def forward(self, v, q, v_mask: bool = True):
        v_num, q_num = v.shape[1], q.shape[1]
        logits = self.logits(v, q)
        if v_mask:
            mask = (v.abs().sum(2) == 0)[:, None, :, None]
            logits = logits.masked_fill(mask, float("-inf"))
        p = torch.softmax(logits.reshape(-1, self.glimpse, v_num * q_num),
                          dim=2)
        return p.reshape(-1, self.glimpse, v_num, q_num), logits


class ConvNet(nn.Module):
    """CNN-LSTM's convolution block (``mmf_tpu/modules/layers.py:34``)
    over [B, C, H, W]: ``conv`` (padded ``kernel_size // 2`` on each side
    for ``"same"``), leaky ReLU at 0.01, a ``pool_stride`` max pool, then
    ``norm``, BatchNorm with flax's statistics. The convolution runs on
    cuDNN on the card."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, padding_size: Any = "same",
                 pool_stride: int = 2, batch_norm: bool = True):
        super().__init__()
        pad = kernel_size // 2 if padding_size == "same" else padding_size
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=pad)
        self.pool_stride = pool_stride
        self.batch_norm = batch_norm
        if batch_norm:
            self.norm = BatchNorm(out_channels)

    def forward(self, x):
        x = F.max_pool2d(F.leaky_relu(self.conv(x), 0.01), self.pool_stride,
                         self.pool_stride)
        return self.norm(x) if self.batch_norm else x
