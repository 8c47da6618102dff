"""VisualBERT: single-stream visio-linguistic transformer.

Port of ``mmf_tpu/models/visual_bert.py``: text tokens and projected
region features are concatenated into one sequence and run through the
shared BERT trunk. Heads: classification with
``pooler_strategy: default | vqa`` and ``nlvr2`` pair pooling, and
``pretraining`` (masked LM over the whole sequence, the visual positions
labelled -1, plus the ``seq_relationship`` score), in eval and training
mode (dropout from the generator that
``modules.transformer.dropout_generator`` installs).

Input contract (same SampleList fields as the JAX model): ``input_ids``,
``input_mask``, ``segment_ids`` (optional), ``image_feature_0``,
``image_info_0.max_features`` (optional), ``lm_label_ids`` for
pretraining, ``img0``/``img1`` nests for nlvr2. Classification outputs
``scores`` (float32) and ``pooled_output``; pretraining outputs
``scores`` (the vocabulary logits as [-1, vocab], compute dtype),
``seq_relationship_score`` and ``losses``
(``{dataset_type}/{dataset_name}/masked_lm_loss``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    Embed,
    MLMHead,
    Pooler,
    PredictionHeadTransform,
    ResidualLayerNorm,
    TransformerConfig,
    TransformerEncoder,
    _dense,
    apply_padding_idx,
    masked_lm_loss,
)
from mmf_tpu_torch.ops.attention import make_attention_bias


class VisualBertEmbeddings(nn.Module):
    """Text embeddings + projected visual embeddings with their own
    position/type tables, concatenated, then LayerNorm."""

    def __init__(self, config: TransformerConfig,
                 visual_embedding_dim: int = 2048):
        super().__init__()
        self.config = config
        hs, dt = config.hidden_size, config.dtype
        self.word_embeddings = Embed(config.vocab_size, hs, dt)
        self.position_embeddings = Embed(
            config.max_position_embeddings, hs, dt
        )
        self.token_type_embeddings = Embed(config.type_vocab_size, hs, dt)
        self.projection = _dense(config, visual_embedding_dim, hs)
        self.position_embeddings_visual = Embed(
            config.max_position_embeddings, hs, dt
        )
        self.token_type_embeddings_visual = Embed(
            config.type_vocab_size, hs, dt
        )
        self.layer_norm = ResidualLayerNorm(hs, config.layer_norm_eps)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, visual_embeddings,
                visual_embeddings_type):
        cfg = self.config
        device = input_ids.device
        positions = torch.arange(input_ids.shape[1], device=device)[None]
        text = (
            apply_padding_idx(
                self.word_embeddings(input_ids), input_ids, cfg.pad_token_id
            )
            + self.position_embeddings(positions)
            + self.token_type_embeddings(token_type_ids)
        )
        v_positions = torch.zeros(
            (1, visual_embeddings.shape[1]), dtype=torch.long, device=device
        )
        visual = (
            self.projection(visual_embeddings)
            + self.position_embeddings_visual(v_positions)
            + self.token_type_embeddings_visual(visual_embeddings_type)
        )
        x = torch.cat([text, visual], dim=1)
        return self.dropout(self.layer_norm(x))


class VisualBertBase(nn.Module):
    def __init__(self, config: TransformerConfig,
                 visual_embedding_dim: int = 2048):
        super().__init__()
        self.config = config
        self.embeddings = VisualBertEmbeddings(config, visual_embedding_dim)
        self.encoder = TransformerEncoder(config)
        self.pooler = Pooler(config)

    def forward(self, input_ids, attention_mask, token_type_ids,
                visual_embeddings, visual_embeddings_type):
        x = self.embeddings(input_ids, token_type_ids, visual_embeddings,
                            visual_embeddings_type)
        bias = make_attention_bias(attention_mask, self.config.dtype)
        x = self.encoder(x, bias=bias)
        return x, self.pooler(x)


@registry.register_model("visual_bert")
class VisualBERT(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        cfg = self._tcfg()
        self.head = self.config.get("training_head_type", "classification")
        self.pooler_strategy = self.config.get("pooler_strategy", "default")
        self.bert = VisualBertBase(
            cfg, self.config.get("visual_embedding_dim", 2048)
        )
        if self.head == "pretraining":
            self.cls = MLMHead(cfg)
            # flax nn.Dense(2) without a dtype: float32 on the pooled
            # output, under bf16 compute too
            self.seq_relationship = Dense(cfg.hidden_size, 2, torch.float32)
            return
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        in_features = cfg.hidden_size
        if self.head == "nlvr2" and self.pooler_strategy != "vqa":
            in_features = 2 * cfg.hidden_size  # pair-concat pooling
        self.classifier_transform = PredictionHeadTransform(cfg, in_features)
        self.num_labels = self.config.get("num_labels", 2)
        # a plain Dense under quant: int8 too, as in JAX
        self.classifier_logits = Dense(cfg.hidden_size, self.num_labels,
                                       cfg.dtype)

    @classmethod
    def config_path(cls):
        return "configs/models/visual_bert/pretrain.yaml"

    def get_weight_decay_mask(self, config=None):
        """Bias and LayerNorm parameters are exempt from weight decay
        (``bert_no_decay_mask``), as in the JAX model."""
        from mmf_tpu_torch.utils.modeling import bert_no_decay_mask

        return bert_no_decay_mask()

    @classmethod
    def format_state_key(cls, key: str) -> str:
        return (
            key.replace("bert.bert", "model.bert")
            .replace("bert.cls", "model.cls")
            .replace("bert.classifier", "model.classifier")
        )

    def _tcfg(self) -> TransformerConfig:
        return TransformerConfig.from_dict(
            {
                k: self.config.get(k)
                for k in (
                    "vocab_size", "hidden_size", "num_hidden_layers",
                    "num_attention_heads", "intermediate_size", "hidden_act",
                    "hidden_dropout_prob", "attention_probs_dropout_prob",
                    "max_position_embeddings", "type_vocab_size",
                    "layer_norm_eps", "dtype", "remat", "quant",
                )
                if self.config.get(k) is not None
            }
        )

    def _prepare_inputs(self, sample_list) -> Dict[str, torch.Tensor]:
        input_ids = sample_list["input_ids"]
        input_mask = sample_list["input_mask"]
        token_type_ids = sample_list.get("segment_ids")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)

        if self.head == "nlvr2":
            input_ids = torch.cat([input_ids, input_ids], dim=0)
            input_mask = torch.cat([input_mask, input_mask], dim=0)
            token_type_ids = torch.cat([token_type_ids, token_type_ids], 0)
            feats = torch.cat(
                [sample_list["img0"]["image_feature_0"],
                 sample_list["img1"]["image_feature_0"]], dim=0,
            )
            dims = torch.cat(
                [sample_list["img0"]["image_info_0"]["max_features"],
                 sample_list["img1"]["image_info_0"]["max_features"]], dim=0,
            )
        else:
            feats = sample_list["image_feature_0"]
            info = sample_list.get("image_info_0")
            if info is not None and "max_features" in info:
                dims = info["max_features"]
            else:
                dims = torch.full((feats.shape[0],), feats.shape[1],
                                  device=feats.device)

        # image_mask = arange(num_regions) < max_features
        regions = torch.arange(feats.shape[1], device=feats.device)
        image_mask = (regions[None, :] < dims.reshape(-1, 1)).to(
            input_mask.dtype
        )
        out = {
            "input_ids": input_ids,
            "input_mask": input_mask,
            "token_type_ids": token_type_ids,
            "visual_embeddings": feats,
            "visual_embeddings_type": torch.zeros_like(image_mask),
            "attention_mask": torch.cat([input_mask, image_mask], dim=-1),
        }
        if self.head == "pretraining":
            # the visual positions carry no label
            lm = sample_list["lm_label_ids"]
            pad = torch.full(
                (lm.shape[0], out["attention_mask"].shape[1] - lm.shape[1]),
                -1, dtype=lm.dtype, device=lm.device)
            out["masked_lm_labels"] = torch.cat([lm, pad], dim=-1)
        return out

    def forward(self, sample_list: Dict[str, Any]):
        inputs = self._prepare_inputs(sample_list)
        sequence_output, pooled_output = self.bert(
            inputs["input_ids"],
            inputs["attention_mask"],
            inputs["token_type_ids"],
            inputs["visual_embeddings"],
            inputs["visual_embeddings_type"],
        )
        if self.head == "pretraining":
            logits = self.cls(sequence_output)
            loss = masked_lm_loss(logits, inputs["masked_lm_labels"])
            name = sample_list.get("dataset_name", "unknown")
            split = sample_list.get("dataset_type", "train")
            return {
                "seq_relationship_score": self.seq_relationship(
                    pooled_output),
                "scores": logits.reshape(-1, logits.shape[-1]),
                "losses": {f"{split}/{name}/masked_lm_loss": loss},
            }
        if self.head == "nlvr2":
            b = pooled_output.shape[0]
            pooled_output = torch.cat(
                [pooled_output[: b // 2], pooled_output[b // 2:]], dim=1
            )
        if self.pooler_strategy == "vqa":
            # representation of the second-last text token
            idx = inputs["input_mask"].sum(dim=1).long() - 2
            index = idx.view(-1, 1, 1).expand(-1, 1, sequence_output.shape[2])
            pooled_output = torch.gather(sequence_output, 1, index)[:, 0]
        pooled_output = self.dropout(pooled_output)
        x = self.classifier_transform(pooled_output)
        logits = self.classifier_logits(x)
        return {
            "scores": logits.reshape(-1, self.num_labels).float(),
            "pooled_output": pooled_output,
        }
