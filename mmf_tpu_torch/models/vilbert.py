"""ViLBERT: two-stream transformer with co-attention bridges.

Port of ``mmf_tpu/models/vilbert.py``: a text stream (BERT-base) and an
image stream (``v_hidden_size`` 1024, 6 layers) run side by side, bridged
at the configured depths (``t_biattention_id`` / ``v_biattention_id``)
by a connection layer that computes both cross directions (text queries
over image keys and image queries over text keys) through the shared
attention entry point. The interleave schedule is static config, unrolled
in ``ViLBertBase.forward``; ``fixed_t_layer`` / ``fixed_v_layer`` detach
the frozen prefix. ``dynamic_attention`` gates, ``with_coattention:
false``, and the classification, ``nlvr2`` and ``pretraining`` heads
(masked LM, the masked-region loss for ``visual_target`` 0, 1 and 2, and
the ``bi_seq_relationship`` score) are ported.

Parameter names are the flax paths with dots
(``bert.c_layer_3.query1.weight``), so ``params_from_jax`` carries a JAX
init across. The two-stream stack computes in the config's dtype; the
heads' plain layers (``classifier_logits``, ``bi_seq_relationship``,
``img_head_*``) compute in float32, as flax's ``nn.Dense`` and
``nn.LayerNorm`` without a dtype do by promotion. flax infers the width
of ``v_location_embeddings`` from the first batch (5 with
``transformer_bbox`` or with no features info, 4 from a raw ``bbox``):
here it is a ``LazyDense``, sized by ``materialize(sample_list)``, by the
first forward, or by the state dict it loads.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.transformer import (
    _DROPOUT_GENERATOR,
    ACT2FN,
    _DTYPES,
    Dense,
    Dropout,
    LazyDense,
    MLMHead,
    PredictionHeadTransform,
    ResidualLayerNorm,
    TextEmbeddings,
    TransformerConfig,
    attend,
    masked_lm_loss,
)
from mmf_tpu_torch.ops.attention import make_attention_bias

LN_EPS = 1e-12  # flax nn.LayerNorm(epsilon=1e-12) in every layer


def _cdtype(c) -> torch.dtype:
    """The two-stream stack's compute dtype; parameters stay float32."""
    return _DTYPES.get(c.get("dtype", None) or "float32", torch.float32)


def _split_heads(x, h):
    b, s, d = x.shape
    return x.view(b, s, h, d // h).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class ImageSelfAttention(nn.Module):
    """Image-stream self-attention with the optional text-conditioned
    ``dynamic_attention`` gates: a masked mean of the current text stream,
    then ``1 + sigmoid`` of a projection, on the queries and keys."""

    def __init__(self, c):
        super().__init__()
        self.cfg = c
        dt, vh = _cdtype(c), c["v_hidden_size"]
        self.query = Dense(vh, vh, dt)
        self.key = Dense(vh, vh, dt)
        self.value = Dense(vh, vh, dt)
        self.dynamic = bool(c.get("dynamic_attention", False))
        if self.dynamic:
            self.dyLinear_q = Dense(c["hidden_size"], vh, dt)
            self.dyLinear_k = Dense(c["hidden_size"], vh, dt)

    def forward(self, hidden, bias, txt_embedding, txt_attention_mask):
        c = self.cfg
        h = c["v_num_attention_heads"]
        q, k, v = self.query(hidden), self.key(hidden), self.value(hidden)
        if self.dynamic:
            m = txt_attention_mask.to(txt_embedding.dtype)[..., None]
            pool = (txt_embedding * m).sum(1) / m.sum(1).clamp(min=1.0)
            q = q * (1 + torch.sigmoid(self.dyLinear_q(pool)))[:, None, :]
            k = k * (1 + torch.sigmoid(self.dyLinear_k(pool)))[:, None, :]
        ctx = attend(_split_heads(q, h), _split_heads(k, h),
                     _split_heads(v, h), bias,
                     c.get("v_attention_probs_dropout_prob", 0.1),
                     self.training)
        return _merge_heads(ctx)


class ImageLayer(nn.Module):
    """Image-stream transformer layer."""

    def __init__(self, c):
        super().__init__()
        dt, vh = _cdtype(c), c["v_hidden_size"]
        vi = c["v_intermediate_size"]
        self.act = c.get("v_hidden_act", "gelu")
        self.attention_self = ImageSelfAttention(c)
        self.attention_output_dense = Dense(vh, vh, dt)
        self.attention_ln = ResidualLayerNorm(vh, LN_EPS)
        self.intermediate_dense = Dense(vh, vi, dt)
        self.output_dense = Dense(vi, vh, dt)
        self.output_ln = ResidualLayerNorm(vh, LN_EPS)
        self.dropout = Dropout(c.get("v_hidden_dropout_prob", 0.1))

    def forward(self, hidden, bias, txt_embedding, txt_attention_mask):
        att = self.attention_self(hidden, bias, txt_embedding,
                                  txt_attention_mask)
        att = self.dropout(self.attention_output_dense(att))
        hidden = self.attention_ln(att, hidden)
        inter = ACT2FN[self.act](self.intermediate_dense(hidden))
        out = self.dropout(self.output_dense(inter))
        return self.output_ln(out, hidden)


class TextLayer(nn.Module):
    """Text-stream (BERT) transformer layer."""

    def __init__(self, c):
        super().__init__()
        self.cfg = c
        dt, hs = _cdtype(c), c["hidden_size"]
        inter = c["intermediate_size"]
        self.query = Dense(hs, hs, dt)
        self.key = Dense(hs, hs, dt)
        self.value = Dense(hs, hs, dt)
        self.attention_output_dense = Dense(hs, hs, dt)
        self.attention_ln = ResidualLayerNorm(hs, LN_EPS)
        self.intermediate_dense = Dense(hs, inter, dt)
        self.output_dense = Dense(inter, hs, dt)
        self.output_ln = ResidualLayerNorm(hs, LN_EPS)
        self.dropout = Dropout(c.get("hidden_dropout_prob", 0.1))

    def forward(self, hidden, bias):
        c = self.cfg
        h = c["num_attention_heads"]
        ctx = attend(_split_heads(self.query(hidden), h),
                     _split_heads(self.key(hidden), h),
                     _split_heads(self.value(hidden), h), bias,
                     c.get("attention_probs_dropout_prob", 0.1),
                     self.training)
        att = self.dropout(self.attention_output_dense(_merge_heads(ctx)))
        hidden = self.attention_ln(att, hidden)
        inter = ACT2FN[c.get("hidden_act", "gelu")](
            self.intermediate_dense(hidden))
        out = self.dropout(self.output_dense(inter))
        return self.output_ln(out, hidden)


class ConnectionLayer(nn.Module):
    """The co-attention bridge and the per-stream FFNs. One module
    computes both cross directions: text queries over image keys and
    values (``query2`` x ``key1``/``value1``), and image queries over text
    keys and values (``query1`` x ``key2``/``value2``). The text-queries
    call drops probabilities at ``v_attention_probs_dropout_prob`` and the
    image-queries call at ``attention_probs_dropout_prob``, as in JAX.
    Each call's bias is its key side's padding mask."""

    def __init__(self, c):
        super().__init__()
        self.cfg = c
        dt, bi = _cdtype(c), c["bi_hidden_size"]
        vh, hs = c["v_hidden_size"], c["hidden_size"]
        vi, ti = c["v_intermediate_size"], c["intermediate_size"]
        self.query1 = Dense(vh, bi, dt)
        self.key1 = Dense(vh, bi, dt)
        self.value1 = Dense(vh, bi, dt)
        self.query2 = Dense(hs, bi, dt)
        self.key2 = Dense(hs, bi, dt)
        self.value2 = Dense(hs, bi, dt)
        self.biout_dense1 = Dense(bi, vh, dt)
        self.biout_ln1 = ResidualLayerNorm(vh, LN_EPS)
        self.biout_dense2 = Dense(bi, hs, dt)
        self.biout_ln2 = ResidualLayerNorm(hs, LN_EPS)
        self.v_intermediate = Dense(vh, vi, dt)
        self.v_output = Dense(vi, vh, dt)
        self.v_output_ln = ResidualLayerNorm(vh, LN_EPS)
        self.t_intermediate = Dense(hs, ti, dt)
        self.t_output = Dense(ti, hs, dt)
        self.t_output_ln = ResidualLayerNorm(hs, LN_EPS)
        self.v_dropout = Dropout(c.get("v_hidden_dropout_prob", 0.1))
        self.t_dropout = Dropout(c.get("hidden_dropout_prob", 0.1))

    def forward(self, v_hidden, v_bias, t_hidden, t_bias):
        c = self.cfg
        h = c["bi_num_attention_heads"]
        v_rate = c.get("v_attention_probs_dropout_prob", 0.1)
        t_rate = c.get("attention_probs_dropout_prob", 0.1)
        # text queries over image keys and values: the context for text
        ctx1 = attend(_split_heads(self.query2(t_hidden), h),
                      _split_heads(self.key1(v_hidden), h),
                      _split_heads(self.value1(v_hidden), h), v_bias,
                      v_rate, self.training)
        # image queries over text keys and values: the context for image
        ctx2 = attend(_split_heads(self.query1(v_hidden), h),
                      _split_heads(self.key2(t_hidden), h),
                      _split_heads(self.value2(t_hidden), h), t_bias,
                      t_rate, self.training)
        v_att = self.biout_ln1(
            self.v_dropout(self.biout_dense1(_merge_heads(ctx2))), v_hidden)
        t_att = self.biout_ln2(
            self.t_dropout(self.biout_dense2(_merge_heads(ctx1))), t_hidden)

        v_int = ACT2FN[c.get("v_hidden_act", "gelu")](
            self.v_intermediate(v_att))
        v_final = self.v_output_ln(self.v_dropout(self.v_output(v_int)),
                                   v_att)
        t_int = ACT2FN[c.get("hidden_act", "gelu")](
            self.t_intermediate(t_att))
        t_final = self.t_output_ln(self.t_dropout(self.t_output(t_int)),
                                   t_att)
        return v_final, t_final


def _text_config(c) -> TransformerConfig:
    return TransformerConfig.from_dict({
        k: c.get(k) for k in (
            "vocab_size", "hidden_size", "num_attention_heads",
            "intermediate_size", "hidden_dropout_prob",
            "max_position_embeddings", "type_vocab_size", "dtype")
        if c.get(k) is not None})


class ViLBertBase(nn.Module):
    """The two-stream encoder with the interleave schedule: for each
    co-attention id pair, the text layers up to ``t_biattention_id``, the
    image layers up to ``v_biattention_id``, then the connection layer;
    the remaining image and text layers after the last. Returns (text
    sequence, image sequence, text pooled, image pooled); the poolers use
    ReLU, not BERT's tanh."""

    def __init__(self, c):
        super().__init__()
        self.cfg = c
        dt, vh = _cdtype(c), c["v_hidden_size"]
        self.embeddings = TextEmbeddings(_text_config(c))
        self.v_image_embeddings = Dense(c["v_feature_size"], vh, dt)
        self.v_location_embeddings = LazyDense(vh, dt)
        self.v_embeddings_ln = ResidualLayerNorm(vh, LN_EPS)
        self.v_dropout = Dropout(c.get("hidden_dropout_prob", 0.1))
        for i in range(c["num_hidden_layers"]):
            self.add_module(f"layer_{i}", TextLayer(c))
        for i in range(c["v_num_hidden_layers"]):
            self.add_module(f"v_layer_{i}", ImageLayer(c))
        self.v_bi_ids = list(c["v_biattention_id"])
        self.t_bi_ids = list(c["t_biattention_id"])
        self.with_coattention = c.get("with_coattention", True)
        if self.with_coattention:
            for i in range(len(self.v_bi_ids)):
                self.add_module(f"c_layer_{i}", ConnectionLayer(c))
        self.fixed_t = c.get("fixed_t_layer", 0)
        self.fixed_v = c.get("fixed_v_layer", 0)
        self.t_pooler = Dense(c["hidden_size"], c["bi_hidden_size"], dt)
        self.v_pooler = Dense(vh, c["bi_hidden_size"], dt)

    def forward(self, input_ids, image_feature, image_location,
                token_type_ids, attention_mask, image_attention_mask):
        c = self.cfg
        dt = _cdtype(c)
        t_bias = make_attention_bias(attention_mask, dt)
        v_bias = make_attention_bias(image_attention_mask, dt)

        txt = self.embeddings(input_ids, token_type_ids)
        img = (self.v_image_embeddings(image_feature)
               + self.v_location_embeddings(image_location))
        img = self.v_dropout(self.v_embeddings_ln(img))

        def text_layer(idx, x):
            out = getattr(self, f"layer_{idx}")(x, t_bias)
            return out.detach() if idx < self.fixed_t else out

        def image_layer(idx, x, txt):
            out = getattr(self, f"v_layer_{idx}")(x, v_bias, txt,
                                                  attention_mask)
            return out.detach() if idx < self.fixed_v else out

        v_start = t_start = 0
        for count, (v_end, t_end) in enumerate(zip(self.v_bi_ids,
                                                   self.t_bi_ids)):
            if not (self.fixed_t <= t_end and self.fixed_v <= v_end):
                raise ValueError(
                    f"fixed_t_layer {self.fixed_t} / fixed_v_layer "
                    f"{self.fixed_v} reach past co-attention {count} "
                    f"(text {t_end}, image {v_end})")
            for idx in range(t_start, t_end):
                txt = text_layer(idx, txt)
            for idx in range(v_start, v_end):
                img = image_layer(idx, img, txt)
            if self.with_coattention:
                img, txt = getattr(self, f"c_layer_{count}")(
                    img, v_bias, txt, t_bias)
            v_start, t_start = v_end, t_end
        for idx in range(v_start, c["v_num_hidden_layers"]):
            img = getattr(self, f"v_layer_{idx}")(img, v_bias, txt,
                                                  attention_mask)
        for idx in range(t_start, c["num_hidden_layers"]):
            txt = getattr(self, f"layer_{idx}")(txt, t_bias)
        pooled_t = F.relu(self.t_pooler(txt[:, 0]))
        pooled_v = F.relu(self.v_pooler(img[:, 0]))
        return txt, img, pooled_t, pooled_v


def nce_negative_index(bsz: int, nreg: int, num_negative: int,
                       generator: torch.Generator,
                       device: Any = "cpu") -> torch.Tensor:
    """Flat indices [B, R, n] (into the B * R regions) of the negatives of
    ``visual_target`` 2: ``int(0.7 n)`` drawn across the batch (never the
    region's own image) and ``int(0.3 n)`` inside the region's image
    (never the region itself), with JAX's rules."""
    n_across, n_inside = int(num_negative * 0.7), int(num_negative * 0.3)

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=device)

    rows = torch.arange(bsz, device=device)[:, None, None]
    cols = torch.arange(nreg, device=device)[None, :, None]
    row_across = randint(max(bsz - 1, 1), (bsz, nreg, n_across))
    row_across = torch.where(row_across == rows, bsz - 1, row_across)
    col_across = randint(nreg, (bsz, nreg, n_across))
    col_inside = randint(max(nreg - 1, 1), (bsz, nreg, n_inside))
    col_inside = torch.where(col_inside == cols, nreg - 1, col_inside)
    return torch.cat([row_across * nreg + col_across,
                      rows * nreg + col_inside], dim=2)


def masked_image_loss(v_logits, target, image_label, visual_target: int,
                      negative_index: Optional[torch.Tensor] = None):
    """The masked-region loss over the regions labelled 1: 0 is the KL
    divergence from the detector's class probabilities, 1 the MSE on the
    region features (normalised by the masked elements), 2 the NCE of the
    region's own target against the negatives at ``negative_index``
    (scored by dot product, the positive at index 0)."""
    logits = v_logits.float()
    tgt = target.float()
    mask = (image_label == 1).float()
    if visual_target == 0:
        lp = torch.log_softmax(logits, -1)
        kld = torch.where(
            tgt == 0, torch.zeros_like(tgt),
            tgt * (torch.log(torch.where(tgt == 0, torch.ones_like(tgt), tgt))
                   - lp)).sum(2)
        return (kld * mask).sum() / mask.sum().clamp(min=1.0)
    if visual_target == 1:
        sq = (logits - tgt) ** 2
        return (sq * mask[..., None]).sum() / (
            mask.sum() * sq.shape[-1]).clamp(min=1.0)
    if visual_target == 2:
        bsz, nreg = logits.shape[:2]
        negative = tgt.reshape(bsz * nreg, -1)[negative_index]
        sample_v = torch.cat([tgt[:, :, None], negative], dim=2)
        score = torch.einsum("brnd,brd->brn", sample_v, logits)
        lp0 = torch.log_softmax(score, -1)[..., 0]
        return -(lp0 * mask).sum() / mask.sum().clamp(min=1.0)
    raise ValueError(f"unknown visual_target {visual_target}")


@registry.register_model("vilbert")
class ViLBERT(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        self.head = c.get("training_head_type", "classification")
        self.fusion = c.get("fusion_method", "mul")
        if self.fusion not in ("sum", "mul"):
            raise ValueError(f"unknown fusion_method {self.fusion!r}")
        bi = c["bi_hidden_size"]
        self.bert = ViLBertBase(c)
        if self.head == "pretraining":
            self.visual_target = int(c.get("visual_target", 0))
            self.cls_text = MLMHead(TransformerConfig.from_dict({
                "vocab_size": c.get("vocab_size", 30522),
                "hidden_size": c.get("hidden_size", 768),
                "dtype": c.get("dtype", "float32")}))
            vh = c.get("v_hidden_size", 1024)
            # flax layers without a dtype: float32 by promotion
            self.img_head_transform = Dense(vh, vh, torch.float32)
            self.img_head_ln = ResidualLayerNorm(vh, LN_EPS)
            self.img_head_decoder = Dense(vh, c.get("v_target_size", 1601),
                                          torch.float32)
            self.itm_dropout = Dropout(0.1)
            self.bi_seq_relationship = Dense(bi, 2, torch.float32)
            return
        self.dropout = Dropout(c.get("hidden_dropout_prob", 0.1))
        pooled = 2 * bi if self.head == "nlvr2" else bi
        self.classifier_transform = PredictionHeadTransform(
            TransformerConfig.from_dict(
                {"hidden_size": pooled, "dtype": c.get("dtype", "float32")}),
            pooled)
        self.num_labels = c.get("num_labels", 2)
        self.classifier_logits = Dense(pooled, self.num_labels,
                                       torch.float32)

    @classmethod
    def config_path(cls):
        return "configs/models/vilbert/pretrain.yaml"

    @classmethod
    def format_state_key(cls, key: str) -> str:
        return key.replace("bert.bert", "model.bert")

    def get_weight_decay_mask(self, config=None):
        """Bias and LayerNorm parameters are exempt from weight decay
        (``bert_no_decay_mask``), as in the JAX model."""
        from mmf_tpu_torch.utils.modeling import bert_no_decay_mask

        return bert_no_decay_mask()

    def materialize(self, sample_list: Dict[str, Any]) -> "ViLBERT":
        """Size ``v_location_embeddings`` by the width of the batch's
        region locations (no forward needed)."""
        loc = self._get_image_and_text_features(sample_list)[
            "image_location"]
        self.bert.v_location_embeddings.materialize(loc.shape[-1])
        return self

    def _get_image_and_text_features(self, sample_list):
        input_ids = sample_list["input_ids"]
        input_mask = sample_list["input_mask"]
        segment_ids = sample_list.get("segment_ids")
        if segment_ids is None:
            segment_ids = torch.zeros_like(input_ids)
        image_target = None
        if self.head == "nlvr2":
            input_ids = torch.cat([input_ids, input_ids], 0)
            input_mask = torch.cat([input_mask, input_mask], 0)
            segment_ids = torch.cat([segment_ids, segment_ids], 0)
            pair = [sample_list["img0"], sample_list["img1"]]
            feats = torch.cat([s["image_feature_0"] for s in pair], 0)
            dims = torch.cat([s["image_info_0"]["max_features"]
                              for s in pair], 0)
            locs = torch.cat([s["image_info_0"]["bbox"] for s in pair], 0)
        else:
            feats = sample_list["image_feature_0"]
            info = sample_list.get("image_info_0") or {}
            dims = info.get("max_features")
            if dims is None:
                dims = torch.full((feats.shape[0],), feats.shape[1],
                                  device=feats.device)
            locs = info.get("bbox")
            if locs is None:
                locs = torch.zeros(feats.shape[:2] + (5,),
                                   device=feats.device)
            image_target = info.get("cls_prob")
        regions = torch.arange(feats.shape[1], device=feats.device)
        image_mask = (regions[None, :] < dims.reshape(-1, 1)).to(
            input_mask.dtype)
        return {
            "input_ids": input_ids,
            "attention_mask": input_mask,
            "token_type_ids": segment_ids,
            "image_feature": feats,
            "image_location": locs,
            "image_attention_mask": image_mask,
            "image_target": image_target,
            "masked_lm_labels": sample_list.get("lm_label_ids"),
            "image_label": sample_list.get("image_labels"),
        }

    def _fused(self, pooled_t, pooled_v):
        return pooled_t + pooled_v if self.fusion == "sum" \
            else pooled_t * pooled_v

    def _negative_index(self, bsz, nreg, device):
        """``visual_target`` 2's negatives, drawn from the installed
        dropout generator in a training step, else from a generator
        seeded 0 (JAX falls back to ``PRNGKey(0)``)."""
        g = _DROPOUT_GENERATOR.get()
        if g is None or g.device != torch.device(device):
            g = torch.Generator(device=device).manual_seed(0)
        return nce_negative_index(bsz, nreg,
                                  int(self.config.get("num_negative", 128)),
                                  g, device)

    def forward(self, sample_list: Dict[str, Any]):
        inp = self._get_image_and_text_features(sample_list)
        txt, img, pooled_t, pooled_v = self.bert(
            inp["input_ids"], inp["image_feature"], inp["image_location"],
            inp["token_type_ids"], inp["attention_mask"],
            inp["image_attention_mask"])
        if self.head != "pretraining":
            pooled = self.dropout(self._fused(pooled_t, pooled_v))
            if self.head == "nlvr2":
                # the batch was doubled block-wise: pair by halves
                b = pooled.shape[0]
                pooled = torch.cat([pooled[: b // 2], pooled[b // 2:]], 1)
            logits = self.classifier_logits(
                self.classifier_transform(pooled))
            return {"scores": logits.reshape(-1, self.num_labels).float()}

        name = sample_list.get("dataset_name", "unknown")
        split = sample_list.get("dataset_type", "train")
        losses = {}
        t_logits = self.cls_text(txt)
        if inp["masked_lm_labels"] is not None:
            losses[f"{split}/{name}/masked_lm_loss"] = masked_lm_loss(
                t_logits, inp["masked_lm_labels"])
        v_trans = self.img_head_ln(ACT2FN["gelu"](
            self.img_head_transform(img)))
        v_logits = self.img_head_decoder(v_trans)
        if inp["image_target"] is not None and inp["image_label"] is not None:
            index = None
            if self.visual_target == 2:
                index = self._negative_index(*v_logits.shape[:2],
                                             v_logits.device)
            losses[f"{split}/{name}/masked_img_loss"] = masked_image_loss(
                v_logits, inp["image_target"], inp["image_label"],
                self.visual_target, index)
        fused = self.itm_dropout(self._fused(pooled_t, pooled_v))
        return {
            "seq_relationship_score": self.bi_seq_relationship(fused),
            "scores": t_logits.reshape(-1, t_logits.shape[-1]),
            "losses": losses,
        }
