"""ViLT: text tokens and image patches through one ViT encoder.

Port of ``mmf_tpu/models/vilt.py``: BERT-style text embeddings and ViT
patch embeddings, each plus a modality type embedding, concatenated
[text; image] and run through a pre-LN ViT encoder (``modules/vit.py``)
under one mask over text and patches; the heads its config names per
dataset (``mlp``, ``itm``, ``mlm``, ``mlm_multi``, ...) come from the
transformer-heads registry (``models/transformers``). The ITM and MLM
labels are inferred as in JAX, and an ``mlm`` head scores a second
encoder pass over the masked ids (``hs_masked_for_mlm``). Losses are
named ``{dataset_type}/{dataset_name}/{loss}``.

ViLT computes in float32 from end to end, as the JAX model does (none of
its modules is given a dtype). The encoder's ``hidden_dropout_prob`` is
0 and its attention-probability dropout ``TransformerConfig``'s 0.1, as
JAX builds it (the YAML's ``hidden_dropout_prob`` is not read); the text
embeddings drop at 0.1. The ITM / MLM heads' lr multipliers are not
applied (JAX's ``get_lr_multipliers`` gives None), and every bias and
LayerNorm parameter is exempt from weight decay.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.transformers.base import (
    BaseTransformer,
    build_heads_dict,
    flax_ordered_heads,
)
from mmf_tpu_torch.modules.transformer import (
    Embed,
    TextEmbeddings,
    TransformerConfig,
)
from mmf_tpu_torch.modules.vit import ViTModel, ViTPatchEmbeddings


class ViLTImageEmbedding(nn.Module):
    """Patch embeddings plus the image type embedding (reference
    vilt.py:22-79); a [B, N, 3, H, W] stack of images is flattened to
    B * N images."""

    def __init__(self, hidden_size: int = 768, patch_size: int = 16,
                 image_size: int = 224):
        super().__init__()
        self.embedding = ViTPatchEmbeddings(hidden_size, patch_size,
                                            image_size)
        self.token_type_embeddings = Embed(2, hidden_size)

    def forward(self, image):
        if image.dim() == 5:
            image = image.reshape((-1,) + tuple(image.shape[2:]))
        emb = self.embedding(image)
        ones = torch.ones(emb.shape[:2], dtype=torch.long, device=emb.device)
        return emb + self.token_type_embeddings(ones)


class ViLTTextEmbedding(nn.Module):
    """BERT's text embeddings plus a second token-type embedding of the
    segment ids: the official model adds them twice (reference
    vilt.py:82-115)."""

    def __init__(self, hidden_size: int = 768, vocab_size: int = 30522,
                 max_position_embeddings: int = 512):
        super().__init__()
        self.text_embeddings = TextEmbeddings(TransformerConfig(
            hidden_size=hidden_size, vocab_size=vocab_size,
            max_position_embeddings=max_position_embeddings))
        self.token_type_embeddings = Embed(2, hidden_size)

    def forward(self, input_ids, segment_ids):
        emb = self.text_embeddings(input_ids, segment_ids)
        return emb + self.token_type_embeddings(segment_ids.long())


def _image_size(params) -> int:
    """The first of ``image_size`` (a pair or a number)."""
    size = params.get("image_size", [224, 224])
    if not isinstance(size, (int, str)):
        size = size[0]
    return int(size)


@registry.register_model("vilt")
class ViLT(BaseTransformer):
    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        hidden = c.get("hidden_size", 768)
        img_params = (c.get("image_encoder", {}) or {}).get("params",
                                                            {}) or {}
        te_cfg = c.get("text_embeddings", {}) or {}
        self.text_embeddings = ViLTTextEmbedding(
            hidden,
            te_cfg.get("vocab_size", c.get("vocab_size", 30522)),
            te_cfg.get("max_position_embeddings",
                       c.get("max_position_embeddings", 512)))
        self.image_embeddings = ViLTImageEmbedding(
            hidden, img_params.get("patch_size", 16),
            _image_size(img_params))
        self.encoder = ViTModel(
            hidden_size=hidden,
            num_hidden_layers=c.get("num_hidden_layers", 12),
            num_attention_heads=c.get("num_attention_heads", 12),
            intermediate_size=img_params.get("mlp_dim", hidden * 4),
            do_patch_embeddings=False, add_pooling_layer=False)
        head_configs = flax_ordered_heads(c.get("heads", {}) or {}, c)
        tasks = c.get("tasks", None)
        if tasks is None:
            tasks = list(head_configs.keys()) if hasattr(
                head_configs, "keys") else []
        if isinstance(tasks, str):
            tasks = tasks.split(",")
        self.heads_dict = self.add_heads(build_heads_dict(
            head_configs, tasks, losses=c.get("losses", {})))

    @classmethod
    def config_path(cls):
        return "configs/models/vilt/defaults.yaml"

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        super().init_weights(generator, std)
        self.image_embeddings.embedding.init_weights(generator, std)
        return self

    @staticmethod
    def _infer_itm_labels(sample_list):
        if "is_correct" in sample_list:
            is_correct = sample_list["is_correct"]
        else:
            is_correct = torch.ones(sample_list["input_ids"].shape[0],
                                    dtype=torch.int32,
                                    device=sample_list["input_ids"].device)
        return {"is_correct": is_correct.to(torch.int32)}

    @staticmethod
    def _infer_mlm_labels(sample_list, image_token_len):
        if "lm_label_ids" in sample_list:
            text = sample_list["lm_label_ids"]
        else:
            text = torch.full_like(sample_list["input_ids"], -1)
        image = torch.full((text.shape[0], image_token_len), -1,
                           dtype=text.dtype, device=text.device)
        return {"text": text, "image": image,
                "combined_labels": torch.cat([text, image], -1)}

    def forward(self, sample_list: Dict[str, Any]):
        text = self.text_embeddings(sample_list["input_ids"],
                                    sample_list["segment_ids"])
        image = self.image_embeddings(sample_list["image"])
        sl = dict(sample_list)
        dataset = sl.get("dataset_name", "unknown")
        head_string = " ".join(self.heads_dict.names_for(dataset))
        if "itm" in head_string:
            sl["itm_labels"] = self._infer_itm_labels(sample_list)
        if "mlm" in head_string:
            sl["mlm_labels"] = self._infer_mlm_labels(sample_list,
                                                      image.shape[1])

        def ones(emb):
            return torch.ones(emb.shape[:2], dtype=torch.int32,
                              device=emb.device)

        text_mask = sample_list.get("input_mask")
        image_mask = sample_list.get("image_mask")
        mask = torch.cat([ones(text) if text_mask is None else text_mask,
                          ones(image) if image_mask is None else image_mask],
                         dim=1)
        sequence, _ = self.encoder(torch.cat([text, image], 1), mask)
        if "mlm" in head_string:
            # the MLM loss scores a second pass over the masked ids
            # (reference vilt.py:270-283 _encode_mlm): scored on the
            # unmasked pass, each target would be read off its own
            # embedding
            masked_ids = sample_list.get("input_ids_masked",
                                         sample_list["input_ids"])
            masked_text = self.text_embeddings(masked_ids,
                                               sample_list["segment_ids"])
            sl["hs_masked_for_mlm"], _ = self.encoder(
                torch.cat([masked_text, image], 1), mask)
        outputs = self.heads_dict(dataset, sequence, sl)
        if "losses" in outputs:
            dt = sl.get("dataset_type", "train")
            outputs["losses"] = {f"{dt}/{dataset}/{k}": v
                                 for k, v in outputs["losses"].items()}
        return outputs
