"""BUTD: bottom-up top-down attention captioning.

Port of ``mmf_tpu/models/butd.py``. A decode step (``BUTDStep``) runs
the top-down attention LSTM on the previous word, attends over the
regions (a weight-normalised score a region, masked past
``max_features`` when ``image_info_0`` carries it, softmax over the
regions) and runs the language LSTM on the attended feature, which
scores the next word. Every decode runs a fixed number of steps:

- teacher forcing, with ``text`` in the batch and the inference type
  neither ``beam_search`` nor ``nucleus_sampling``: step t reads
  ``text[:, t]``; the scores [B, max_length, V] are padded with 1.0
  past the text's length. As the reference does (and the JAX package
  does not, ROADMAP C.10), the forward adds ``targets = text[:, 1:]`` to
  the batch, so ``caption_cross_entropy`` scores step t against the
  next word;
- greedy decoding from SOS otherwise (and in training under the
  sampling types, as in JAX);
- in evaluation, fixed-beam search (``beam_length`` beams stay alive for
  every step, finished ones pinned on EOS at +0; the result is the best
  finished beam by its raw sum, else the best beam) and nucleus
  sampling (the smallest set of words whose probability reaches
  ``sum_threshold``, drawn from the installed
  ``utils.text.sampling_generator``); both return ``captions`` and a
  dummy loss, so the configured loss is skipped.

SOS and EOS are the registry's ``butd_sos_index`` and
``butd_eos_index`` (1 and 2 by default). The regions' projection for
the attention, their mean and the LSTMs' fused weights are computed
once a forward (``TopDownAttentionLSTM.prepare``), not at every step:
the same values.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.nn import functional as F

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.models.pythia import Pythia
from mmf_tpu_torch.modules.decoders import LanguageDecoder
from mmf_tpu_torch.modules.encoders import build_image_encoder
from mmf_tpu_torch.modules.layers import (
    TopDownAttentionLSTM,
    add_wn_dense,
    weight_norm_weight,
)
from mmf_tpu_torch.modules.transformer import Embed
from mmf_tpu_torch.utils.text import current_sampling_generator

NEG = -1e9


class BUTDStep(nn.Module):
    """One decode step: attention LSTM -> attend -> language LSTM."""

    def __init__(self, image_dim: int, embedding_dim: int,
                 attention_dim: int, hidden_dim: int, vocab_size: int,
                 dropout: float = 0.5, fc_bias_init: float = 0.0,
                 attn_dropout: float = 0.5):
        super().__init__()
        self.top_down_attention = TopDownAttentionLSTM(
            image_dim, embedding_dim, attention_dim, hidden_dim,
            attn_dropout)
        add_wn_dense(self, "attn_transform", 0, attention_dim, 1)
        self.language_decoder = LanguageDecoder(
            image_dim, vocab_size, hidden_dim, dropout, fc_bias_init)

    def prepare(self, image_feat):
        """What every step of a decode over these regions shares."""
        return (self.top_down_attention.prepare(image_feat),
                weight_norm_weight(self.Dense_0, self.attn_transform),
                self.language_decoder.prepare())

    def forward(self, image_feat, embedding, state, feature_mask, prepared):
        td, attn_w, lm = prepared
        joint, state = self.top_down_attention(image_feat, embedding, state,
                                               td)
        raw_attn = F.linear(joint, attn_w, self.Dense_0.bias)  # [B, K, 1]
        if feature_mask is not None:
            raw_attn = torch.where(feature_mask[..., None] > 0, raw_attn,
                                   torch.full_like(raw_attn, NEG))
        attn = torch.softmax(raw_attn, dim=1)
        weighted = torch.bmm(attn.transpose(1, 2), image_feat)[:, 0]
        return self.language_decoder(weighted, state, lm)


@registry.register_model("butd")
class BUTD(Pythia):
    def __init__(self, config: Any = None):
        BaseModel.__init__(self, config)
        cfg = self.config
        self.vocab_size = self._vocab_size()
        self.max_length = self._max_length()
        cls_params = cfg["classifier"]["params"]
        self.hidden_dim = cls_params["hidden_dim"]
        fe_cfg = cfg.get("image_feature_embeddings", [])
        mc_params = (dict(fe_cfg[0].get("modal_combine", {}).get(
            "params", {})) if fe_cfg else {})
        attention_dim = mc_params.get("attention_dim", self.hidden_dim)
        embedding_dim = cfg.get("embedding_dim", 300)
        inference = cfg.get("inference", {}) or {}
        self.inference_type = inference.get("type", "greedy")
        self.inference_params = dict(inference.get("params", {}) or {})

        self.word_embedding = Embed(self.vocab_size, embedding_dim)
        enc_cfg = cfg["image_feature_encodings"]
        if not hasattr(enc_cfg, "keys"):  # a list: the first
            enc_cfg = enc_cfg[0]
        params = dict(enc_cfg.get("params", {}) or {})
        params.setdefault("in_dim", cfg.get("image_feature_dim", 2048))
        encoder = build_image_encoder(
            {"type": enc_cfg["type"], "params": params}, direct_features=True)
        self.encoder_name = f"{type(encoder).__name__}_0"
        self.add_module(self.encoder_name, encoder)
        self.step = BUTDStep(
            encoder.out_dim, embedding_dim, attention_dim, self.hidden_dim,
            self.vocab_size, cls_params.get("dropout", 0.5),
            cls_params.get("fc_bias_init", 0.0),
            attn_dropout=mc_params.get("dropout", 0.5))

    @classmethod
    def config_path(cls):
        return "configs/models/butd/defaults.yaml"

    def _vocab_size(self) -> int:
        tp = registry.get(self._datasets()[0] + "_text_processor",
                          no_warning=True)
        if tp is not None and hasattr(tp, "get_vocab_size"):
            return tp.get_vocab_size()
        return self.config.get("text_vocab_size", 10000)

    def _max_length(self) -> int:
        tp = registry.get(self._datasets()[0] + "_text_processor",
                          no_warning=True)
        if tp is not None and hasattr(tp, "max_length"):
            return tp.max_length
        return self.config.get("max_length", 52)

    def _zero_state(self, rows: int, like: torch.Tensor):
        z = like.new_zeros(rows, self.hidden_dim)
        return {"td_hidden": (z, z), "lm_hidden": (z, z)}

    @staticmethod
    def _decode_output(sample_list, captions):
        ds = sample_list.get("dataset_name", "unknown")
        dt = sample_list.get("dataset_type", "test")
        # a dummy loss, so the configured loss is skipped
        return {"captions": captions,
                "losses": {f"{dt}/{ds}/dummy_loss":
                           captions.new_zeros(captions.shape[0],
                                              dtype=torch.float32)}}

    def forward(self, sample_list: Dict[str, Any]):
        image_feat = getattr(self, self.encoder_name)(
            sample_list["image_feature_0"])
        info = sample_list.get("image_info_0", {}) or {}
        max_feats = info.get("max_features", None)
        feature_mask = None
        if max_feats is not None:
            feature_mask = (torch.arange(image_feat.shape[1],
                                         device=image_feat.device)[None, :]
                            < max_feats.reshape(-1, 1)).float()
        sos = registry.get("butd_sos_index", no_warning=True) or 1
        eos = registry.get("butd_eos_index", no_warning=True) or 2
        sampling = self.inference_type in ("beam_search", "nucleus_sampling")
        if not self.training and self.inference_type == "beam_search":
            return self._decode_output(sample_list, self._beam_search(
                image_feat, feature_mask, sos, eos))
        if not self.training and self.inference_type == "nucleus_sampling":
            return self._decode_output(sample_list, self._nucleus_sampling(
                image_feat, feature_mask, sos, eos))

        b = image_feat.shape[0]
        state = self._zero_state(b, image_feat)
        prepared = self.step.prepare(image_feat)
        scores = []
        if "text" in sample_list and not sampling:
            texts = sample_list["text"].long()
            sample_list["targets"] = texts[:, 1:]
            for t in range(min(self.max_length, texts.shape[1])):
                out, state = self.step(image_feat,
                                       self.word_embedding(texts[:, t]),
                                       state, feature_mask, prepared)
                scores.append(out)
        else:
            prev = torch.full((b,), sos, dtype=torch.long,
                              device=image_feat.device)
            for _ in range(self.max_length):
                out, state = self.step(image_feat, self.word_embedding(prev),
                                       state, feature_mask, prepared)
                scores.append(out)
                prev = out.argmax(dim=-1)
        scores = torch.stack(scores, dim=1)
        if scores.shape[1] < self.max_length:
            scores = F.pad(scores,
                           (0, 0, 0, self.max_length - scores.shape[1]),
                           value=1.0)
        return {"scores": scores}

    @torch.no_grad()
    def _beam_search(self, image_feat, feature_mask, sos: int, eos: int):
        k = int(self.inference_params.get("beam_length", 5))
        b, v, dev = image_feat.shape[0], self.vocab_size, image_feat.device
        feat_k = image_feat.repeat_interleave(k, dim=0)
        fmask_k = (feature_mask.repeat_interleave(k, dim=0)
                   if feature_mask is not None else None)
        state = self._zero_state(b * k, image_feat)
        prepared = self.step.prepare(feat_k)
        seqs = torch.zeros(b, k, self.max_length, dtype=torch.long,
                           device=dev)
        beam_scores = torch.where(torch.arange(k, device=dev) == 0, 0.0,
                                  NEG).expand(b, k)
        finished = torch.zeros(b, k, dtype=torch.bool, device=dev)
        prev = torch.full((b * k,), sos, dtype=torch.long, device=dev)
        eos_only = torch.full((v,), NEG, device=dev)
        eos_only[eos] = 0.0
        offsets = (torch.arange(b, device=dev) * k)[:, None]
        for t in range(self.max_length):
            out, state = self.step(feat_k, self.word_embedding(prev), state,
                                   fmask_k, prepared)
            lp = torch.log_softmax(out.float(), dim=-1).reshape(b, k, v)
            cand = torch.where(finished[:, :, None], eos_only, lp)
            flat = (beam_scores[:, :, None] + cand).reshape(b, k * v)
            beam_scores, idx = flat.topk(k, dim=1)
            prev_beam, word = idx // v, idx % v
            seqs = seqs.gather(1, prev_beam[:, :, None].expand_as(seqs))
            seqs[:, :, t] = word
            gather = (prev_beam + offsets).reshape(-1)
            state = {key: tuple(s[gather] for s in pair)
                     for key, pair in state.items()}
            finished = finished.gather(1, prev_beam) | (word == eos)
            prev = word.reshape(-1)
        pick = torch.where(finished, beam_scores, beam_scores + NEG)
        best = torch.where(finished.any(dim=1), pick.argmax(dim=1),
                           beam_scores.argmax(dim=1))
        return seqs[torch.arange(b, device=dev), best]

    @torch.no_grad()
    def _nucleus_sampling(self, image_feat, feature_mask, sos: int,
                          eos: int):
        p = float(self.inference_params.get("sum_threshold", 0.5))
        b, dev = image_feat.shape[0], image_feat.device
        gen = current_sampling_generator(dev)
        state = self._zero_state(b, image_feat)
        prepared = self.step.prepare(image_feat)
        caps = torch.zeros(b, self.max_length, dtype=torch.long, device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        prev = torch.full((b,), sos, dtype=torch.long, device=dev)
        for t in range(self.max_length):
            out, state = self.step(image_feat, self.word_embedding(prev),
                                   state, feature_mask, prepared)
            order, kept_p = nucleus(torch.softmax(out.float(), dim=-1), p)
            choice = torch.multinomial(kept_p, 1, generator=gen)
            word = order.gather(1, choice)[:, 0]
            word = torch.where(finished, torch.full_like(word, eos), word)
            caps[:, t] = word
            finished = finished | (word == eos)
            prev = word
        return caps


def nucleus(probs: torch.Tensor, threshold: float):
    """The words in order of probability and each one's probability, 0
    outside the smallest set whose sum reaches ``threshold`` (the first
    word always kept: ``cum - p < threshold``)."""
    sorted_p, order = probs.sort(dim=-1, descending=True, stable=True)
    keep = (sorted_p.cumsum(dim=-1) - sorted_p) < threshold
    return order, torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
