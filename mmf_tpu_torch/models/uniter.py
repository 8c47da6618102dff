"""UNITER: a single-stream encoder with a head per task.

Port of ``mmf_tpu/models/uniter.py``. The question's tokens (BERT's
embeddings) and the regions (the feature and a 7-wide box projection,
each through its LayerNorm, plus the image token type, then a
LayerNorm) run through one BERT trunk. The image stream reads the text
stream's token-type table: one parameter, not two. ``_pos_feat`` makes
the box row [x1, y1, x2, y2, w, h, w·h] from ``image_info_0.bbox``
(``img_pos_feat`` when the batch carries it, else zeros).

Classification runs the head of the batch's dataset (``heads.<dataset>``,
an ``mlp`` by default). Pretraining (``do_pretraining``) runs the task
the trainer drew for the update (``sample_list["task"]``, from
``get_step_meta``, which draws from Python's ``random`` as JAX's trainer
does), or every task of ``tasks`` with their losses summed when no task
is given (evaluation): ``mlm`` over ``input_ids_masked`` when the batch
has it, ``itm`` against ``is_correct``, ``mrc`` against the detector's
``cls_prob`` (zeros without it) and ``mrfr`` against the features, over
the regions labelled 1 (whose features take the learned mask row), and
``wra``, the optimal-transport alignment. The trunk runs once a task.
Every task's head is built with the model (flax builds the called ones:
the init's, which call every task), so a JAX init carries across whole;
``mrc``'s decoder is as wide as the batch's ``cls_prob``
(``materialize``). The heads' ``lr_multiplier`` is not read, in JAX
either. Losses are named ``{dataset_type}/{dataset_name}/{loss}``.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel
from mmf_tpu_torch.models.transformers.base import build_head
from mmf_tpu_torch.modules.transformer import (
    Dense,
    Dropout,
    Embed,
    Pooler,
    ResidualLayerNorm,
    TextEmbeddings,
    TransformerConfig,
    TransformerEncoder,
)
from mmf_tpu_torch.ops.attention import make_attention_bias

DEFAULT_PRETRAINING_TASKS = "mlm,itm,mrc,mrfr,wra"
MRC_TARGET_SIZE = 1601  # the detector's classes, when no cls_prob is given
POS_DIM = 7


class UNITERImageEmbeddings(nn.Module):
    """Region features (with the learned mask row added on masked
    regions, when built ``masked``) and box rows, each projected and
    normalised, plus the token-type rows given, then a LayerNorm."""

    def __init__(self, config: TransformerConfig, img_dim: int,
                 masked: bool):
        super().__init__()
        hs, dt, eps = config.hidden_size, config.dtype, 1e-12
        if masked:
            # [2, img_dim], row 1 the mask; flax's Embed without a dtype
            self.mask_embedding = Embed(2, img_dim, torch.float32)
        self.img_linear = Dense(img_dim, hs, dt)
        self.img_layer_norm = ResidualLayerNorm(hs, eps)
        self.pos_linear = Dense(POS_DIM, hs, dt)
        self.pos_layer_norm = ResidualLayerNorm(hs, eps)
        self.final_layer_norm = ResidualLayerNorm(hs, eps)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, img_feat, img_pos_feat, type_embeddings,
                img_masks=None):
        if img_masks is not None:
            masks = img_masks.long()
            img_feat = img_feat + (self.mask_embedding(masks)
                                   * masks[..., None].to(img_feat.dtype))
        im = self.img_layer_norm(self.img_linear(img_feat))
        pos = self.pos_layer_norm(self.pos_linear(img_pos_feat))
        return self.dropout(self.final_layer_norm(im + pos
                                                  + type_embeddings))


class UNITERModelBase(nn.Module):
    def __init__(self, config: TransformerConfig, img_dim: int = 2048,
                 masked: bool = False):
        super().__init__()
        self.config = config
        self.text_embeddings = TextEmbeddings(config)
        self.img_embeddings = UNITERImageEmbeddings(config, img_dim, masked)
        self.encoder = TransformerEncoder(config)
        self.pooler = Pooler(config)  # JAX's has it; no head reads it

    def forward(self, input_ids, position_ids, img_feat, img_pos_feat,
                attention_mask, img_masks=None):
        txt = self.text_embeddings(input_ids, position_ids=position_ids)
        # the image's token type from the text stream's table
        img_type_ids = torch.ones(img_feat.shape[:2], dtype=torch.long,
                                  device=img_feat.device)
        type_emb = self.text_embeddings.token_type_embeddings(img_type_ids)
        img = self.img_embeddings(img_feat, img_pos_feat, type_emb,
                                  img_masks)
        x = torch.cat([txt, img], dim=1)
        bias = make_attention_bias(attention_mask, self.config.dtype)
        return self.encoder(x, bias=bias)


@registry.register_model("uniter")
class UNITER(BaseModel):
    def __init__(self, config: Any = None):
        super().__init__(config)
        cfg = self._tcfg()
        self.do_pretraining = bool(self.config.get("do_pretraining", False))
        tasks = self._tasks()
        self.uniter = UNITERModelBase(
            cfg, self.config.get("img_dim", 2048),
            masked=self.do_pretraining and bool({"mrc", "mrfr"} & set(tasks)))
        heads_cfg = self.config.get("heads", {}) or {}
        for task in tasks:
            head_config = heads_cfg.get(task, {
                "type": "mlp", "num_labels": 2,
                "hidden_size": cfg.hidden_size})
            head = build_head(dict(head_config))
            if task == "mrfr" and hasattr(head.decoder, "materialize"):
                # the regression targets are the features
                head.decoder.materialize(self.config.get("img_dim", 2048))
            self.add_module(f"head_{task}", head)

    @classmethod
    def config_path(cls):
        return "configs/models/uniter/defaults.yaml"

    def _tcfg(self) -> TransformerConfig:
        # the trunk's widths ride under encoder.params in the YAML; the
        # flat keys take precedence
        enc = dict((self.config.get("encoder", {}) or {}).get("params", {})
                   or {})

        def get(key, default):
            return self.config.get(key, enc.get(key, default))

        return TransformerConfig.from_dict({
            "hidden_size": get("hidden_size", 768),
            "num_hidden_layers": get("num_hidden_layers", 12),
            "num_attention_heads": get("num_attention_heads", 12),
            "intermediate_size": get("intermediate_size",
                                     get("hidden_size", 768) * 4),
            "vocab_size": get("vocab_size", 30522),
            "hidden_dropout_prob": get("hidden_dropout_prob", 0.0),
            "dtype": get("dtype", "float32"),
            "quant": get("quant", "none"),
        })

    def _tasks(self) -> List[str]:
        tasks = self.config.get("tasks", DEFAULT_PRETRAINING_TASKS)
        return tasks.split(",") if isinstance(tasks, str) else list(tasks)

    def get_step_meta(self) -> Dict[str, Any]:
        """The pretraining task of one update, drawn from Python's
        ``random`` on the host; the trainer adds it to the batch."""
        if self.do_pretraining:
            return {"task": random.choice(self._tasks())}
        return {}

    def materialize(self, sample_list: Dict[str, Any]) -> "UNITER":
        """Size ``mrc``'s decoder by the batch's ``cls_prob`` width."""
        head = getattr(self, "head_mrc", None)
        if head is not None and hasattr(head.decoder, "materialize"):
            info = sample_list.get("image_info_0") or {}
            cls_prob = info.get("cls_prob") if hasattr(info, "get") else None
            head.decoder.materialize(MRC_TARGET_SIZE if cls_prob is None
                                     else cls_prob.shape[-1])
        return self

    @staticmethod
    def _pos_feat(sample_list, img_feat):
        if "img_pos_feat" in sample_list:
            return sample_list["img_pos_feat"]
        info = sample_list.get("image_info_0") or {}
        if hasattr(info, "get") and info.get("bbox") is not None:
            bbox = info["bbox"][:, :, :4].float()
            w = (bbox[:, :, 2] - bbox[:, :, 0])[..., None]
            h = (bbox[:, :, 3] - bbox[:, :, 1])[..., None]
            return torch.cat([bbox, w, h, w * h], dim=-1)
        return torch.zeros(img_feat.shape[:2] + (POS_DIM,),
                           device=img_feat.device)

    def _task_inputs(self, task, sl, input_ids, img_feat, input_mask,
                     image_mask):
        """The task's head inputs added to a copy of the sample list."""
        device = img_feat.device
        batch, regions = img_feat.shape[:2]
        labels = sl.get("image_labels")
        if labels is None:
            labels = torch.zeros((batch, regions), dtype=torch.long,
                                 device=device)
        correct = sl.get("is_correct")
        if correct is None:
            correct = torch.ones(batch, dtype=torch.long, device=device)
        if task == "mlm":
            lm = sl.get("lm_label_ids")
            if lm is None:
                lm = torch.full(input_ids.shape, -1, dtype=torch.long,
                                device=device)
            pad = torch.full((batch, regions), -1, dtype=lm.dtype,
                             device=device)
            sl["mlm_labels"] = {"combined_labels": torch.cat([lm, pad], 1)}
        elif task == "itm":
            sl["is_correct"] = correct
        elif task == "mrc":
            info = sl.get("image_info_0") or {}
            targets = info.get("cls_prob") if hasattr(info, "get") else None
            if targets is None:
                targets = torch.zeros((batch, regions, MRC_TARGET_SIZE),
                                      device=device)
            sl["mrc_labels"] = {"targets": targets, "is_masked": labels == 1}
        elif task == "mrfr":
            sl["mrfr_labels"] = {"targets": img_feat,
                                 "is_masked": labels == 1}
        elif task == "wra":
            sl["wra_info"] = {
                "txt_len": input_mask.sum(1), "img_len": image_mask.sum(1),
                "txt_pad": 1 - input_mask, "img_pad": 1 - image_mask,
                "is_correct": correct}
        return sl

    def forward(self, sample_list: Dict[str, Any]):
        input_ids = sample_list["input_ids"]
        img_feat = sample_list["image_feature_0"]
        img_pos_feat = self._pos_feat(sample_list, img_feat)
        input_mask = sample_list["input_mask"]
        image_mask = sample_list.get("image_mask")
        if image_mask is None:
            image_mask = torch.ones(img_feat.shape[:2],
                                    dtype=input_mask.dtype,
                                    device=img_feat.device)
        attention_mask = torch.cat([input_mask, image_mask], dim=1)
        position_ids = torch.arange(input_ids.shape[1],
                                    device=input_ids.device)[None]

        if self.do_pretraining:
            task = sample_list.get("task", None)
            tasks_to_run = [task] if task else self._tasks()
        else:
            tasks_to_run = [sample_list.get("dataset_name",
                                            self._tasks()[0])]

        output: Dict[str, Any] = {}
        merged_losses: Dict[str, Any] = {}
        for task in tasks_to_run:
            task_ids = input_ids
            if (self.do_pretraining and task == "mlm"
                    and "input_ids_masked" in sample_list):
                task_ids = sample_list["input_ids_masked"]
            img_masks = None
            if (self.do_pretraining and task in ("mrc", "mrfr")
                    and "image_labels" in sample_list):
                img_masks = sample_list["image_labels"] == 1
            seq = self.uniter(task_ids, position_ids, img_feat,
                              img_pos_feat, attention_mask, img_masks)
            sl = dict(sample_list)
            if self.do_pretraining:
                sl = self._task_inputs(task, sl, task_ids, img_feat,
                                       input_mask, image_mask)
            head = getattr(self, f"head_{task}", None)
            if head is None:
                raise ValueError(
                    f"UNITER has no head for {task!r}: its heads are "
                    f"{self._tasks()} (model_config.uniter.tasks)")
            for key, value in head(seq, processed_sample_list=sl).items():
                if key == "losses":
                    merged_losses.update(value)
                else:
                    output[key] = value
        if merged_losses:
            name = sample_list.get("dataset_name", "unknown")
            split = sample_list.get("dataset_type", "train")
            output["losses"] = {f"{split}/{name}/{k}": v
                                for k, v in merged_losses.items()}
        return output
