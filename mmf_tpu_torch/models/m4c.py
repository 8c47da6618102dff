"""M4C: multimodal transformer with a pointer network, for TextVQA.

Port of ``mmf_tpu/models/m4c.py`` (reference mmf/models/m4c.py:573).
TextBert (3 layers) encodes the question; the object branch projects
the objects' fc7 features (``ImageFinetune`` over fc6) and boxes; the OCR
branch projects fasttext (300) + PHOC (604) + the OCR boxes' fc7 (2048) +
the order vectors, and the boxes; the MMT joint transformer runs over
[txt, obj, ocr, dec] with a prefix-LM bias (every token sees the
encoding tokens; the decode span is causal); the scores are the fixed
answer vocabulary's classifier concatenated with OcrPtrNet's copy
scores over the OCR tokens.

- Training (``model.train()``) is the teacher-forced full pass over
  ``train_prev_inds``: one encoder call at the full [B, 1, S, S] bias,
  through the attention kernels' stats form with K2/K3 behind it when
  attention-probability dropout is 0. The ``text_bert`` and ``mmt``
  sections' ``attention_probs_dropout_prob`` sets it; the YAML sets
  none, so it is ``TransformerConfig``'s 0.1, which routes training
  attention to the plain version, as in JAX.
- Evaluation greedy-decodes: ``MMT.prefill`` encodes the decode-invariant
  [txt, obj, ocr] prefix once and returns each layer's prefix K/V; then
  a Python loop runs ``max_copy_steps`` (12) ``MMT.decode_step`` calls,
  each pushing only the 12 decode tokens through the stack against the
  cached prefix K/V ([B, H, 12, D] queries over 170 + 12 keys), and
  feeds each step's argmax back. This equals the reference's 12 full
  passes: prefix queries never see decode keys, and their -10000 bias
  underflows to zero weight after the softmax's max subtraction.
- ``decode_unroll`` and ``decode_budget_samples`` are JAX's compile
  policy for its ``nn.scan`` over the steps (the unroll factor from a
  table of TPU compile and decode times). The port has nothing to
  compile: it accepts the keys and uses no number from them.
- ``PrevPredEmbeddings`` gathers the previous step's answer rows from
  the answer table and the OCR rows from the OCR embeddings, by index,
  where JAX broadcasts the table to [B, V + O, H] first: the same rows
  (the values are equal), without the [B, 5050, 768] tensor a step.
- Every flax ``nn.LayerNorm`` of M4C (the four feature LayerNorms, the
  three of ``PrevPredEmbeddings``) is a ``ResidualLayerNorm`` here, as
  the port's ViT and ViLBERT map theirs: the LayerNorm kernel (K4, and
  K4-bwd in training) on the card. JAX runs them as plain XLA.

Parameter names are the flax paths with dots (``mmt.encoder.layer_0.
attention.query.weight``, ``classifier_w``), so ``params_from_jax``
carries a JAX init across.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.embeddings import ImageFinetune
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    Embed,
    ResidualLayerNorm,
    TextEmbeddings,
    TransformerConfig,
    TransformerEncoder,
)

MASK_BIAS = -10000.0  # the reference's additive mask value


def _get_mask(nums, max_num):
    return (torch.arange(max_num, device=nums.device)[None, :]
            < nums.reshape(-1, 1)).float()


def _normalize(x, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


class TextBert(nn.Module):
    """Question encoder (reference m4c.py:350-372)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = TransformerEncoder(cfg)

    def forward(self, txt_inds, txt_mask):
        x = self.embeddings(txt_inds)
        bias = ((1.0 - txt_mask) * MASK_BIAS)[:, None, None, :]
        return self.encoder(x, bias=bias)


class PrevPredEmbeddings(nn.Module):
    """Decode-step input embeddings from the previous predictions
    (reference m4c.py:493-539): index i < V is answer row i, index
    V + j is OCR token j; plus position and type (answer or OCR)
    embeddings."""

    MAX_DEC_LENGTH = 100
    MAX_TYPE_NUM = 5

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        hidden, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ans_layer_norm = ResidualLayerNorm(hidden, eps)
        self.ocr_layer_norm = ResidualLayerNorm(hidden, eps)
        self.position_embeddings = Embed(self.MAX_DEC_LENGTH, hidden)
        self.token_type_embeddings = Embed(self.MAX_TYPE_NUM, hidden)
        self.emb_layer_norm = ResidualLayerNorm(hidden, eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, ans_emb, ocr_emb, prev_inds):
        B, T = prev_inds.shape
        ans_num = ans_emb.shape[0]
        ans_emb = self.ans_layer_norm(ans_emb)
        ocr_emb = self.ocr_layer_norm(ocr_emb)
        prev_inds = prev_inds.long()
        is_ans = prev_inds < ans_num
        from_ans = F.embedding(prev_inds.clamp(max=ans_num - 1), ans_emb)
        ocr_inds = (prev_inds - ans_num).clamp(min=0)
        from_ocr = torch.gather(
            ocr_emb, 1,
            ocr_inds[..., None].expand(B, T, ocr_emb.shape[-1]))
        raw_dec = torch.where(is_ans[..., None], from_ans, from_ocr)

        pos = self.position_embeddings(
            torch.arange(T, device=prev_inds.device)[None, :])
        typ = self.token_type_embeddings((~is_ans).long())
        emb = self.dropout(self.emb_layer_norm(pos + typ))
        return raw_dec + emb


class MMT(nn.Module):
    """Joint transformer over [txt, obj, ocr, dec] with the prefix-LM bias
    (reference m4c.py:375-456)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.prev_pred_embeddings = PrevPredEmbeddings(cfg)
        self.encoder = TransformerEncoder(cfg)

    def forward(self, txt_emb, txt_mask, obj_emb, obj_mask, ocr_emb,
                ocr_mask, fixed_ans_emb, prev_inds):
        dec_emb = self.prev_pred_embeddings(fixed_ans_emb, ocr_emb,
                                            prev_inds)
        dec_max_num = dec_emb.shape[1]
        dec_mask = torch.zeros(dec_emb.shape[:2], dtype=torch.float32,
                               device=dec_emb.device)
        encoder_inputs = torch.cat([txt_emb, obj_emb, ocr_emb, dec_emb], 1)
        attention_mask = torch.cat([txt_mask, obj_mask, ocr_mask, dec_mask],
                                   1)
        B, S = attention_mask.shape
        # every query sees the encoding tokens; the decode span is causal
        ext = attention_mask[:, None, None, :].expand(B, 1, S, S).clone()
        ext[:, :, -dec_max_num:, -dec_max_num:] = torch.tril(torch.ones(
            dec_max_num, dec_max_num, device=ext.device))
        bias = ((1.0 - ext) * MASK_BIAS).to(self.cfg.dtype)
        seq = self.encoder(encoder_inputs, bias=bias)

        txt_max, obj_max = txt_mask.shape[-1], obj_mask.shape[-1]
        ocr_max = ocr_mask.shape[-1]
        return {
            "mmt_seq_output": seq,
            "mmt_txt_output": seq[:, :txt_max],
            "mmt_ocr_output": seq[:, txt_max + obj_max:
                                  txt_max + obj_max + ocr_max],
            "mmt_dec_output": seq[:, -dec_max_num:],
        }

    def prefill(self, txt_emb, txt_mask, obj_emb, obj_mask, ocr_emb,
                ocr_mask):
        """Encode the decode-invariant [txt, obj, ocr] prefix once:
        (its output, each layer's prefix (k, v), its mask)."""
        enc_in = torch.cat([txt_emb, obj_emb, ocr_emb], 1)
        enc_mask = torch.cat([txt_mask, obj_mask, ocr_mask], 1)
        bias = ((1.0 - enc_mask[:, None, None, :]) * MASK_BIAS).to(
            self.cfg.dtype)
        seq, kvs = self.encoder(enc_in, bias=bias, return_kv=True)
        return seq, kvs, enc_mask

    def decode_step(self, prefix_kvs, enc_mask, fixed_ans_emb, ocr_emb,
                    prev_inds):
        """One pass of only the decode tokens: each layer attends over
        [cached prefix K/V ; causal decode K/V]."""
        dec_emb = self.prev_pred_embeddings(fixed_ans_emb, ocr_emb,
                                            prev_inds)
        B, T = dec_emb.shape[:2]
        enc_part = enc_mask[:, None, None, :].float().expand(
            B, 1, T, enc_mask.shape[-1])
        causal = torch.tril(torch.ones(T, T, device=dec_emb.device))[
            None, None].expand(B, 1, T, T)
        bias = ((1.0 - torch.cat([enc_part, causal], -1))
                * MASK_BIAS).to(self.cfg.dtype)
        return self.encoder(dec_emb, bias=bias, prefix_kvs=prefix_kvs)


class OcrPtrNet(nn.Module):
    """Dynamic pointer scores over the OCR tokens (reference
    m4c.py:459-490)."""

    def __init__(self, hidden_size: int,
                 query_key_size: Optional[int] = None):
        super().__init__()
        self.qk = query_key_size or hidden_size
        self.query = Dense(hidden_size, self.qk)
        self.key = Dense(hidden_size, self.qk)

    def forward(self, query_inputs, key_inputs, attention_mask):
        ext_mask = ((1.0 - attention_mask) * MASK_BIAS)[:, None, :]
        q = self.query(query_inputs)
        k = self.key(key_inputs)
        scores = torch.einsum("btq,bsq->bts", q, k) / float(self.qk) ** 0.5
        return scores + ext_mask


@registry.register_model("m4c")
class M4C(BaseModel):
    """Builds its classifier from ``{dataset}_num_final_outputs`` in the
    registry (the TextVQA builder registers it), so construct it after
    the datasets, as the trainer does."""

    def __init__(self, config: Any = None):
        super().__init__(config)
        c = config
        mmt_cfg = self._mmt_cfg()
        text_cfg = self._text_cfg()
        hidden = mmt_cfg.hidden_size
        self.hidden = hidden
        self.text_bert = TextBert(text_cfg)
        if text_cfg.hidden_size != hidden:
            self.text_bert_out_linear = Dense(text_cfg.hidden_size, hidden)
        num_choices = self._num_choices()
        self.classifier_w = nn.Parameter(torch.zeros(num_choices, hidden))
        self.classifier_b = nn.Parameter(torch.zeros(num_choices))

        self.obj_faster_rcnn_fc7 = ImageFinetune(
            c["obj"].get("mmt_in_dim", 2048), out_dim_hint=2048)
        self.ocr_faster_rcnn_fc7 = ImageFinetune(2048, out_dim_hint=2048)
        fc7 = self.obj_faster_rcnn_fc7.out_dim
        self.linear_obj_feat_to_mmt_in = Dense(fc7, hidden)
        self.obj_feat_layer_norm = ResidualLayerNorm(hidden, 1e-5)
        self.linear_obj_bbox_to_mmt_in = Dense(4, hidden)
        self.obj_bbox_layer_norm = ResidualLayerNorm(hidden, 1e-5)
        self.obj_dropout = Dropout(c["obj"].get("dropout_prob", 0.1))
        self.linear_ocr_feat_to_mmt_in = Dense(
            c["ocr"].get("mmt_in_dim", 3002), hidden)
        self.ocr_feat_layer_norm = ResidualLayerNorm(hidden, 1e-5)
        self.linear_ocr_bbox_to_mmt_in = Dense(4, hidden)
        self.ocr_bbox_layer_norm = ResidualLayerNorm(hidden, 1e-5)
        self.ocr_dropout = Dropout(c["ocr"].get("dropout_prob", 0.1))

        self.mmt = MMT(mmt_cfg)
        self.ocr_ptr_net = OcrPtrNet(
            hidden,
            c["classifier"]["ocr_ptr_net"].get("query_key_size", None))

    @classmethod
    def config_path(cls):
        return "configs/models/m4c/defaults.yaml"

    def get_lr_multipliers(self, config=None):
        c = self.config
        return {
            "text_bert": c.get("lr_scale_text_bert", 0.1),
            "obj_faster_rcnn_fc7": c.get("lr_scale_frcn", 0.1),
            "ocr_faster_rcnn_fc7": c.get("lr_scale_frcn", 0.1),
            "mmt": c.get("lr_scale_mmt", 1.0),
        }

    @staticmethod
    def _bert_cfg_from(section, defaults):
        """BertConfig(**section): every key the reference's BertConfig
        takes flows through (reference m4c.py:39,72)."""
        cfg = dict(defaults)
        for key in (
            "vocab_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size",
            "hidden_dropout_prob", "attention_probs_dropout_prob",
            "max_position_embeddings", "type_vocab_size", "hidden_act",
            "layer_norm_eps", "initializer_range", "dtype", "quant",
        ):
            if key in section:
                cfg[key] = section[key]
        cfg.setdefault("intermediate_size", cfg.get("hidden_size", 768) * 4)
        return TransformerConfig.from_dict(cfg)

    def _mmt_cfg(self):
        mmt = dict(self.config.get("mmt", {}) or {})
        mmt.setdefault("dtype", self.config.get("dtype", "float32"))
        mmt.setdefault("quant", self.config.get("quant", "none"))
        return self._bert_cfg_from(
            mmt, {"hidden_size": 768, "num_hidden_layers": 4,
                  "num_attention_heads": 12})

    def _text_cfg(self):
        tb = dict(self.config.get("text_bert", {}) or {})
        tb.setdefault("dtype", self.config.get("dtype", "float32"))
        tb.setdefault("quant", self.config.get("quant", "none"))
        return self._bert_cfg_from(
            tb, {"vocab_size": 30522, "hidden_size": 768,
                 "num_hidden_layers": 3, "num_attention_heads": 12})

    def _num_choices(self):
        datasets = self.config.get("datasets", None)
        if datasets is None:
            config = registry.get("config", no_warning=True)
            datasets = config["datasets"] if config else None
        if isinstance(datasets, str):
            dataset = datasets.split(",")[0].strip()
        elif isinstance(datasets, (list, tuple)) and datasets:
            dataset = datasets[0]
        else:
            dataset = "textvqa"
        num = registry.get(f"{dataset}_num_final_outputs", no_warning=True)
        if num is None:
            num = self.config.get("num_final_outputs", 5050)
        return num - self.config["classifier"]["ocr_max_num"]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     std: float = 0.02) -> "M4C":
        super().init_weights(generator, std)
        w = torch.empty(self.classifier_w.shape, dtype=torch.float32)
        w.normal_(0.0, std, generator=generator)
        self.classifier_w.copy_(w)
        self.classifier_b.zero_()
        return self

    def _finalize_scores(self, scores):
        """Per-step score hook (reference m4c.py _forward_output); the
        captioner masks ``<unk>`` here."""
        return scores

    def _scores(self, dec, ocr_out, ocr_mask):
        fixed_scores = dec @ self.classifier_w.t() + self.classifier_b
        dyn = self.ocr_ptr_net(dec, ocr_out, ocr_mask)
        return self._finalize_scores(torch.cat([fixed_scores, dyn], -1))

    def _encode(self, sample_list):
        """The question, object and OCR embeddings with their masks."""
        c = self.config
        txt_inds = sample_list["text"]
        txt_mask = _get_mask(sample_list["text_len"], txt_inds.shape[1])
        txt_emb = self.text_bert(txt_inds, txt_mask)
        if hasattr(self, "text_bert_out_linear"):
            txt_emb = self.text_bert_out_linear(txt_emb)

        obj_fc7 = _normalize(self.obj_faster_rcnn_fc7(
            sample_list["image_feature_0"]))
        obj_bbox = sample_list["obj_bbox_coordinates"]
        obj_mmt_in = self.obj_feat_layer_norm(
            self.linear_obj_feat_to_mmt_in(obj_fc7)
        ) + self.obj_bbox_layer_norm(self.linear_obj_bbox_to_mmt_in(obj_bbox))
        obj_mmt_in = self.obj_dropout(obj_mmt_in)
        obj_mask = _get_mask(sample_list["image_info_0"]["max_features"],
                             obj_mmt_in.shape[1])

        ocr_fasttext = _normalize(sample_list["context_feature_0"])
        ocr_phoc = _normalize(sample_list["context_feature_1"])
        assert ocr_fasttext.shape[-1] == 300
        assert ocr_phoc.shape[-1] == 604
        ocr_fc6 = sample_list["image_feature_1"][:, :ocr_fasttext.shape[1]]
        ocr_fc7 = _normalize(self.ocr_faster_rcnn_fc7(ocr_fc6))
        order_vectors = torch.zeros_like(sample_list["order_vectors"])
        ocr = c["ocr"]
        if ocr.get("remove_ocr_fasttext", False):
            ocr_fasttext = torch.zeros_like(ocr_fasttext)
        if ocr.get("remove_ocr_phoc", False):
            ocr_phoc = torch.zeros_like(ocr_phoc)
        if ocr.get("remove_ocr_frcn", False):
            ocr_fc7 = torch.zeros_like(ocr_fc7)
        ocr_feat = torch.cat([ocr_fasttext, ocr_phoc, ocr_fc7, order_vectors],
                             -1)
        ocr_bbox = sample_list["ocr_bbox_coordinates"]
        if ocr.get("remove_ocr_semantics", False):
            ocr_feat = torch.zeros_like(ocr_feat)
        if ocr.get("remove_ocr_bbox", False):
            ocr_bbox = torch.zeros_like(ocr_bbox)
        ocr_mmt_in = self.ocr_feat_layer_norm(
            self.linear_ocr_feat_to_mmt_in(ocr_feat)
        ) + self.ocr_bbox_layer_norm(self.linear_ocr_bbox_to_mmt_in(ocr_bbox))
        ocr_mmt_in = self.ocr_dropout(ocr_mmt_in)
        ocr_mask = _get_mask(sample_list["context_info_0"]["max_features"],
                             ocr_mmt_in.shape[1])
        return txt_emb, txt_mask, obj_mmt_in, obj_mask, ocr_mmt_in, ocr_mask

    def forward(self, sample_list: Dict[str, Any]):
        encoded = self._encode(sample_list)
        train_prev_inds = sample_list["train_prev_inds"].long()
        if self.training:
            res = self.mmt(*encoded, self.classifier_w, train_prev_inds)
            scores = self._scores(res["mmt_dec_output"],
                                  res["mmt_ocr_output"], encoded[5])
            return {"scores": scores}
        return {"scores": self.greedy_decode(encoded,
                                             train_prev_inds.shape[1])}

    def greedy_decode(self, encoded, steps: int):
        """The prefix encoded once, then ``steps`` decode passes over the
        cached prefix K/V, each step's argmax fed to the next: the last
        pass's scores [B, steps, num_choices + ocr]."""
        txt_emb, txt_mask, obj_mmt_in, obj_mask, ocr_mmt_in, ocr_mask = \
            encoded
        B = txt_emb.shape[0]
        bos_idx = int(self.config.get("bos_idx", 1))
        inds = torch.zeros(B, steps, dtype=torch.long, device=txt_emb.device)
        inds[:, 0] = bos_idx
        enc_seq, prefix_kvs, enc_mask = self.mmt.prefill(*encoded)
        start = txt_mask.shape[-1] + obj_mask.shape[-1]
        ocr_out = enc_seq[:, start:start + ocr_mask.shape[-1]]
        scores = None
        for _ in range(steps):
            dec = self.mmt.decode_step(prefix_kvs, enc_mask,
                                       self.classifier_w, ocr_mmt_in, inds)
            scores = self._scores(dec, ocr_out, ocr_mask).float()
            argmax_inds = scores.argmax(-1)
            inds = torch.cat([inds[:, :1], argmax_inds[:, :-1]], 1)
        return scores
