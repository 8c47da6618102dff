"""Shared BERT-family transformer trunk, eval and training modes.

Port of ``mmf_tpu/modules/transformer.py``. Module and parameter names
mirror the flax scopes with dots (``encoder.layer_0.attention.query.
weight``), so ``utils/checkpoint_updater.py::params_from_jax`` maps a JAX
param tree onto these modules mechanically.

Precision follows the JAX modules: ``config.dtype`` is the compute dtype
and parameters are created float32. ``Dense`` and ``Embed`` cast their
input and weights to the compute dtype in ``forward`` (a no-op once
``BaseModel.to_compute_dtype`` has cast the weights, which the serving
engine does once); LayerNorm parameters stay float32.

Dropout (``Dropout``, and attention-probability dropout through
``dot_product_attention``) draws its masks from an explicit
``torch.Generator`` that the caller installs with ``dropout_generator``
for the length of a training forward: the counterpart of flax's
``rngs={"dropout": key}``. A module in training mode with a rate above 0
and no generator installed raises, as flax does without a dropout rng.

``quant: int8`` (or ``MMF_TPU_QUANT=int8``, which takes precedence, as in
JAX) makes every ``_dense`` projection a ``QuantDense``: the int8 GEMM
kernel (K5) on the card, its plain version on the CPU.

The encoder's ``prefix_kvs`` (per-layer cached K/V of a prefix that
every call attends to, M4C's greedy decode), ``return_kv`` and
``output_hidden_states`` are ported. Not ported yet: remat, MoE, sequence
and pipeline parallelism (the config fields are accepted;
``moe_experts > 0`` raises).
Dense weights start at zero: ``BaseModel.init_weights`` fills them from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmf_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_bias,
)
from mmf_tpu_torch.ops.layernorm import layer_norm


def _gelu(x):
    """Exact erf GELU for f32 inputs, the tanh form under bf16, as the JAX
    trunk does (its choice was measured on a TPU; the H100's is open).
    ``MMF_TPU_GELU=erf|tanh`` forces either."""
    forced = os.environ.get("MMF_TPU_GELU", "").lower()
    if forced in ("erf", "exact"):
        approx = False
    elif forced in ("tanh", "approx"):
        approx = True
    else:
        approx = x.dtype == torch.bfloat16
    return F.gelu(x, approximate="tanh" if approx else "none")


ACT2FN = {
    "gelu": _gelu,
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}

_DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: Any = torch.float32
    remat: Any = False
    quant: str = "none"
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    pad_token_id: Any = 0
    sequence_parallel: bool = False
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0

    @classmethod
    def from_dict(cls, d, **overrides):
        d = dict(d or {})
        d.update(overrides)
        fields = {f.name for f in dataclasses.fields(cls)}
        if isinstance(d.get("dtype"), str):
            d["dtype"] = _DTYPES[d["dtype"]]
        return cls(**{k: v for k, v in d.items() if k in fields})


_DROPOUT_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "mmf_dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Install ``generator`` as the source of every dropout mask drawn
    inside the block (a training step's forward)."""
    token = _DROPOUT_GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _DROPOUT_GENERATOR.reset(token)


def current_dropout_generator(rate: float) -> torch.Generator:
    """The installed generator; raises when dropout at ``rate`` is due
    and none is installed."""
    g = _DROPOUT_GENERATOR.get()
    if g is None:
        raise RuntimeError(
            f"dropout at rate {rate} in training mode needs a generator: "
            "run the forward inside modules.transformer.dropout_generator"
            "(torch.Generator(device=...)), or call .eval()"
        )
    return g


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode keeps each element with
    probability ``1 - rate`` and scales it by ``1 / (1 - rate)``; the
    mask comes from the installed ``dropout_generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        g = current_dropout_generator(self.rate)
        keep = torch.rand(x.shape, generator=g, device=x.device) < (
            1.0 - self.rate)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def apply_padding_idx(embeds, input_ids, pad_token_id=0):
    """``nn.Embedding(padding_idx=...)`` gradient semantics: pad positions
    give the table no gradient. Forward identity."""
    if pad_token_id is None:
        return embeds
    is_pad = (input_ids == pad_token_id)[..., None]
    return torch.where(is_pad, embeds.detach(), embeds)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=compute, param_dtype=float32)``: input, weight
    and bias are cast to the compute dtype; the product accumulates in
    f32 inside the matmul and returns the compute dtype. ``bias=False`` is
    ``use_bias=False`` (an LSTM cell's input products)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self):
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


# a table of at most this many rows (the token-type embeddings) is read as
# a one-hot product: its gradient is then a GEMM, the same bits on every
# call, where the card's gather backward sums the many repeats of one id
# (a segment id over a whole image) in an order that varies
ONE_HOT_ROWS = 16


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=compute, param_dtype=float32)``. A table of
    at most ``ONE_HOT_ROWS`` rows is read as a one-hot product: the rows'
    own values (each output sums one row and zeros), as long as the
    product does not round its inputs, which an f32 table's would on the
    card with cuBLAS TF32 on (torch's default leaves it off); and a
    deterministic gradient."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, features)
        self.compute_dtype = dtype

    def reset_parameters(self):
        nn.init.zeros_(self.weight)

    def forward(self, ids):
        weight = self.weight.to(self.compute_dtype)
        rows = weight.shape[0]  # a lazily sized table's, once loaded
        if rows <= ONE_HOT_ROWS:
            return F.one_hot(ids.long(), rows).to(weight.dtype) @ weight
        return F.embedding(ids, weight)


class ResidualLayerNorm(nn.Module):
    """LayerNorm(x [+ residual]) through ``ops.layer_norm`` (the Triton
    kernel on the card). Also stands in for flax ``nn.LayerNorm`` (same
    semantics; ``weight``/``bias`` map to flax ``scale``/``bias``)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))
        self.epsilon = epsilon

    def forward(self, x, residual=None):
        return layer_norm(x, self.weight, self.bias, residual=residual,
                          eps=self.epsilon)


def _quant_mode(cfg: TransformerConfig) -> str:
    """``MMF_TPU_QUANT`` (when set) or ``config.quant``, as in JAX."""
    mode = (os.environ.get("MMF_TPU_QUANT", "") or cfg.quant or "none")
    mode = "none" if mode.lower() in ("off", "float", "0") else mode.lower()
    if mode not in ("int8", "none"):
        raise ValueError(
            f"Unsupported quant mode {mode!r}; supported modes are 'int8' "
            "and 'none'."
        )
    return mode


def _dense(cfg: TransformerConfig, in_features: int,
           features: int) -> nn.Module:
    if _quant_mode(cfg) == "int8":
        from mmf_tpu_torch.ops.quant import QuantDense

        return QuantDense(in_features, features, cfg.dtype)
    return Dense(in_features, features, cfg.dtype)


class LazyDense(nn.modules.lazy.LazyModuleMixin, Dense):
    """``Dense`` whose input width is taken from its first input, as a
    flax ``nn.Dense`` takes it at init. The weight is materialised by the
    first forward, by ``materialize(in_features)`` or by
    ``load_state_dict``; the first forward makes the module a ``Dense``.
    Materialise it before ``BaseModel.init_weights`` and before an
    optimizer is built."""

    cls_to_become = Dense

    def __init__(self, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(0, out_features, dtype)
        self.weight = nn.UninitializedParameter()
        self.bias = nn.UninitializedParameter()

    def initialize_parameters(self, x):
        self.materialize(x.shape[-1])

    @torch.no_grad()
    def materialize(self, in_features: int):
        if self.has_uninitialized_params():
            self.in_features = int(in_features)
            self.weight.materialize((self.out_features, self.in_features))
            self.bias.materialize((self.out_features,))
            self.reset_parameters()


def attend(q, k, v, bias, dropout_prob: float, training: bool):
    """``dot_product_attention`` with attention-probability dropout at
    ``dropout_prob`` when ``training``. There are no probabilities to drop
    inside the kernel: a nonzero rate in training routes to the plain
    version, as the JAX dispatcher does."""
    rate, generator = 0.0, None
    if training and dropout_prob > 0.0:
        rate = dropout_prob
        generator = current_dropout_generator(rate)
    return dot_product_attention(q, k, v, bias=bias, dropout_rate=rate,
                                 generator=generator)


class SelfAttention(nn.Module):
    """Multi-head attention block with output projection, dropout and the
    residual LayerNorm. Self- or cross-attention (``kv`` from another
    stream of the same width)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        hs = config.hidden_size
        self.query = _dense(config, hs, hs)
        self.key = _dense(config, hs, hs)
        self.value = _dense(config, hs, hs)
        self.output_dense = _dense(config, hs, hs)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.output_layer_norm = ResidualLayerNorm(hs, config.layer_norm_eps)

    def forward(self, hidden, kv=None, bias=None, prefix_kv=None,
                return_kv=False):
        """``prefix_kv``: cached (k, v) [B, H, S_prefix, D] prepended to
        this call's keys/values; ``return_kv`` also returns this call's
        own split (k, v)."""
        cfg = self.config
        if kv is None:
            kv = hidden
        nh = cfg.num_attention_heads
        d = cfg.hidden_size // nh

        def split(x):
            return x.view(x.shape[0], x.shape[1], nh, d).transpose(1, 2)

        q = split(self.query(hidden))
        k = split(self.key(kv))
        v = split(self.value(kv))
        own_kv = (k, v) if return_kv else None
        if prefix_kv is not None:
            k = torch.cat([prefix_kv[0], k], dim=2)
            v = torch.cat([prefix_kv[1], v], dim=2)
        ctx = attend(q, k, v, bias, cfg.attention_probs_dropout_prob,
                     self.training)
        ctx = ctx.transpose(1, 2).reshape(
            hidden.shape[0], hidden.shape[1], cfg.hidden_size
        )
        out = self.dropout(self.output_dense(ctx))
        out = self.output_layer_norm(out, hidden)
        if return_kv:
            return out, own_kv
        return out


class FeedForward(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.intermediate_dense = _dense(
            config, config.hidden_size, config.intermediate_size
        )
        self.output_dense = _dense(
            config, config.intermediate_size, config.hidden_size
        )
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.output_layer_norm = ResidualLayerNorm(
            config.hidden_size, config.layer_norm_eps
        )

    def forward(self, hidden):
        x = self.intermediate_dense(hidden)
        x = ACT2FN[self.config.hidden_act](x)
        x = self.dropout(self.output_dense(x))
        return self.output_layer_norm(x, hidden)


class TransformerLayer(nn.Module):
    def __init__(self, config: TransformerConfig, moe: bool = False):
        super().__init__()
        if moe and config.moe_experts > 0:
            raise NotImplementedError("MoE feed-forward is not ported yet")
        self.attention = SelfAttention(config)
        self.ffn = FeedForward(config)

    def forward(self, hidden, bias=None, prefix_kv=None, return_kv=False):
        out = self.attention(hidden, bias=bias, prefix_kv=prefix_kv,
                             return_kv=return_kv)
        if return_kv:
            hidden, own_kv = out
            return self.ffn(hidden), own_kv
        return self.ffn(out)


class TransformerEncoder(nn.Module):
    """Stack of layers, unrolled as ``layer_0`` ... ``layer_{n-1}``."""

    def __init__(self, config: TransformerConfig,
                 num_layers: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers or config.num_hidden_layers
        every = max(config.moe_every, 1)
        for i in range(self.num_layers):
            moe = config.moe_experts > 0 and i % every == every - 1
            self.add_module(f"layer_{i}", TransformerLayer(config, moe=moe))

    def forward(self, hidden, bias=None, output_hidden_states=False,
                prefix_kvs=None, return_kv=False):
        """``prefix_kvs``: per-layer cached (k, v) [B, H, S_prefix, D] of
        tokens every query attends to (prepended to each layer's own
        keys; ``bias`` then spans prefix + own keys). ``return_kv``
        returns ``(hidden, [(k, v) of each layer's own tokens])``;
        ``output_hidden_states`` returns ``(hidden, [input, layer 1
        output, ..., last output])``."""
        all_hidden, all_kv = [], []
        for i in range(self.num_layers):
            if output_hidden_states:
                all_hidden.append(hidden)
            layer = getattr(self, f"layer_{i}")
            prefix_kv = None if prefix_kvs is None else prefix_kvs[i]
            if return_kv:
                hidden, kv = layer(hidden, bias, prefix_kv, return_kv=True)
                all_kv.append(kv)
            else:
                hidden = layer(hidden, bias, prefix_kv)
        if output_hidden_states:
            all_hidden.append(hidden)
            return hidden, all_hidden
        if return_kv:
            return hidden, all_kv
        return hidden


class Pooler(nn.Module):
    """CLS pooler: dense + tanh."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.dense = _dense(config, config.hidden_size, config.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class PredictionHeadTransform(nn.Module):
    """dense + act + LayerNorm (BertPredictionHeadTransform). flax infers
    the dense input width; here it is ``in_features`` (default hidden)."""

    def __init__(self, config: TransformerConfig,
                 in_features: Optional[int] = None):
        super().__init__()
        self.config = config
        self.dense = _dense(config, in_features or config.hidden_size,
                            config.hidden_size)
        self.layer_norm = ResidualLayerNorm(
            config.hidden_size, config.layer_norm_eps
        )

    def forward(self, hidden):
        x = ACT2FN[self.config.hidden_act](self.dense(hidden))
        return self.layer_norm(x)


class TextEmbeddings(nn.Module):
    """BERT word/position/token-type embeddings + LayerNorm + dropout."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        hs, dt = config.hidden_size, config.dtype
        self.word_embeddings = Embed(config.vocab_size, hs, dt)
        self.position_embeddings = Embed(config.max_position_embeddings, hs,
                                         dt)
        self.token_type_embeddings = Embed(config.type_vocab_size, hs, dt)
        self.layer_norm = ResidualLayerNorm(hs, config.layer_norm_eps)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                inputs_embeds=None):
        if inputs_embeds is None:
            inputs_embeds = apply_padding_idx(
                self.word_embeddings(input_ids.long()), input_ids,
                self.config.pad_token_id)
        device = inputs_embeds.device
        if position_ids is None:
            position_ids = torch.arange(inputs_embeds.shape[1],
                                        device=device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros(inputs_embeds.shape[:2],
                                         dtype=torch.long, device=device)
        x = (inputs_embeds + self.position_embeddings(position_ids.long())
             + self.token_type_embeddings(token_type_ids.long()))
        return self.dropout(self.layer_norm(x))


class TransformerModel(nn.Module):
    """Full BERT-style model: embeddings -> encoder -> pooler."""

    def __init__(self, config: TransformerConfig,
                 add_pooling_layer: bool = True):
        super().__init__()
        self.config = config
        self.embeddings = TextEmbeddings(config)
        self.encoder = TransformerEncoder(config)
        self.pooler = Pooler(config) if add_pooling_layer else None

    def forward(self, input_ids=None, attention_mask=None,
                token_type_ids=None, position_ids=None, inputs_embeds=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            inputs_embeds)
        bias = None
        if attention_mask is not None:
            bias = make_attention_bias(attention_mask, self.config.dtype)
        x = self.encoder(x, bias=bias)
        return x, (self.pooler(x) if self.pooler is not None else None)


class MLMHead(nn.Module):
    """Masked-LM head: transform + decoder to the vocabulary. Untied, a
    ``decoder`` Dense; ``tied``, the logits are x . E^T plus a float32
    ``bias``, in the compute dtype, with E the ``shared_embedding``
    passed to ``forward`` (flax creates whichever the call takes; here
    the form is chosen at construction). The decoder stays a plain
    Dense under ``quant: int8``, as in JAX."""

    def __init__(self, config: TransformerConfig, tied: bool = False):
        super().__init__()
        self.config = config
        self.transform = PredictionHeadTransform(config)
        self.tied = tied
        if tied:
            self.bias = nn.Parameter(torch.zeros(config.vocab_size))
        else:
            self.decoder = Dense(config.hidden_size, config.vocab_size,
                                 config.dtype)

    def forward(self, hidden, shared_embedding=None):
        x = self.transform(hidden)
        if self.tied != (shared_embedding is not None):
            raise ValueError(
                "a tied MLMHead needs shared_embedding, an untied one "
                "takes none")
        if not self.tied:
            return self.decoder(x)
        dt = self.config.dtype
        logits = x.to(dt) @ shared_embedding.to(dt).t()
        return logits + self.bias.to(dt)


def masked_lm_loss(logits, labels):
    """Mean negative log-likelihood of the labelled positions: a float32
    log_softmax over the vocabulary, positions labelled -1 left out, the
    sum divided by max(count, 1), so no labelled position gives 0 (as in
    JAX; ``F.cross_entropy(ignore_index=-1)`` would give NaN)."""
    valid = labels != -1
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    picked = logprobs.gather(-1, safe[..., None])[..., 0]
    total = torch.where(valid, picked, torch.zeros_like(picked)).sum()
    return -total / valid.sum().clamp(min=1)


def picked_log_prob(logits, labels):
    """log_softmax(logits)[label] a row, in float32 (a classifier's
    cross entropy is its negative mean); a negative label counts from
    the end, as JAX's ``take_along_axis`` reads it."""
    labels = labels.long()
    labels = torch.where(labels < 0, labels + logits.shape[-1], labels)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return logprobs.gather(-1, labels[:, None])[:, 0]
