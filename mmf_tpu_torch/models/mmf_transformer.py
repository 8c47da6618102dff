"""MMFTransformer (``mmf_transformer``, ``mmft``): one transformer over
the modalities its config lists.

Port of ``mmf_tpu/models/mmf_transformer.py``. Each modality gets token,
position and segment embeddings: a text modality a token table, any
other a projection (Dense + LayerNorm) of its features, or of a 4-D
image's grid features through ``build_image_encoder``. The embeddings
are concatenated under the concatenated masks and run through the shared
BERT trunk (``TransformerEncoder``) in the config's dtype (bf16 in the
defaults); the heads (``models/transformers``) compute in float32, an
``mlm`` head's decoder tied to the first text modality's table
(``tie_weights``, on by default).

The embeddings are float32 (flax's ``nn.Embed`` and ``nn.Dense`` here
have no dtype). As in flax, an image modality's encoder exists only once
a 4-D image has needed it: ``materialize`` builds it from such a batch,
``materialize_from_state_dict`` from weights that hold it. flax sizes
two kinds of layer from the data: a feature projection's input width and
a position table (``max(position_dim, sequence length)`` rows); here
they are sized by ``materialize(sample_list)``, by the first forward or
by a state dict. The image encoder runs in inference mode whatever the
model's mode, as JAX calls it without ``train``. The trunk's dropout
rates are ``TransformerConfig``'s (0.1), as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.transformers.base import (
    BaseTransformer,
    build_heads_dict,
    flax_ordered_heads,
)
from mmf_tpu_torch.modules.encoders import build_image_encoder
from mmf_tpu_torch.modules.transformer import (
    Dropout,
    Embed,
    LazyDense,
    ResidualLayerNorm,
    TransformerConfig,
    TransformerEncoder,
)
from mmf_tpu_torch.ops.attention import make_attention_bias

DEFAULT_MODALITIES = [
    {"type": "text", "key": "text", "position_dim": 512,
     "embedding_dim": 768, "segment_id": 0},
    {"type": "image", "key": "image", "embedding_dim": 2048,
     "position_dim": 1, "segment_id": 1,
     "encoder": {"type": "resnet152", "params": {}}},
]


class _PositionTable(nn.modules.lazy.LazyModuleMixin, Embed):
    """A float32 position table of ``max(position_dim, length)`` rows, as
    flax sizes it from the modality's sequence length: sized by
    ``materialize(length)`` or by ``load_state_dict``."""

    cls_to_become = Embed

    def __init__(self, position_dim: int, features: int):
        super().__init__(0, features)
        self.position_dim = int(position_dim)
        self.weight = nn.UninitializedParameter()

    def initialize_parameters(self, ids):
        self.materialize(ids.shape[-1])

    @torch.no_grad()
    def materialize(self, length: int):
        if self.has_uninitialized_params():
            self.num_embeddings = max(self.position_dim, int(length))
            self.weight.materialize((self.num_embeddings,
                                     self.embedding_dim))
            self.reset_parameters()


@registry.register_model("mmft")
@registry.register_model("mmf_transformer")
class MMFTransformer(BaseTransformer):
    def __init__(self, config: Any = None):
        super().__init__(config)
        c = self.config
        self.tcfg = TransformerConfig.from_dict({
            "hidden_size": c.get("hidden_size", 768),
            "num_hidden_layers": c.get("num_hidden_layers", 12),
            "num_attention_heads": c.get("num_attention_heads", 12),
            "intermediate_size": c.get("intermediate_size",
                                       c.get("hidden_size", 768) * 4),
            "vocab_size": c.get("vocab_size", 30522),
            "dtype": c.get("dtype", "float32"),
        })
        hidden = self.tcfg.hidden_size
        self.modalities = [dict(m) for m in c.get("modalities",
                                                  DEFAULT_MODALITIES)]
        self.token_type_embeddings = Embed(len(self.modalities) + 1, hidden)
        self.text_table = None
        encoders = 0
        for idx, m in enumerate(self.modalities):
            if m["type"] == "text":
                table = Embed(self.tcfg.vocab_size, hidden)
                self.add_module(f"token_embeddings_{idx}", table)
                self.text_table = self.text_table or f"token_embeddings_{idx}"
            else:
                if m["type"] == "image" and m.get("encoder") is not None:
                    # built when a 4-D image first needs it; flax names it
                    # by class inside the compact scope
                    cls = registry.get_encoder_class(
                        m["encoder"].get("type", "resnet152"))
                    m["_encoder"] = f"{cls.__name__}_{encoders}"
                    encoders += 1
                self.add_module(f"token_proj_{idx}", LazyDense(hidden))
                self.add_module(f"token_proj_ln_{idx}", ResidualLayerNorm(
                    hidden, m.get("layer_norm_eps", 1e-12)))
            self.add_module(f"pos_embeddings_{idx}", _PositionTable(
                m.get("position_dim", 512), hidden))
            self.add_module(f"layer_norm_{idx}", ResidualLayerNorm(
                hidden, m.get("layer_norm_eps", 1e-12)))
            self.add_module(f"dropout_{idx}", Dropout(m.get(
                "hidden_dropout_prob", self.tcfg.hidden_dropout_prob)))
        self.encoder = TransformerEncoder(self.tcfg)
        heads = c.get("heads", [{"type": "mlp",
                                 "num_labels": c.get("num_labels", 2)}])
        self.heads_dict = self.add_heads(build_heads_dict(
            flax_ordered_heads(heads, c), tasks=[],
            losses=c.get("losses", {})))
        self.tie = bool(c.get("tie_weights", True)) and \
            self.text_table is not None
        if self.tie:
            for head in self.heads_dict.heads.values():
                if head.ties_embeddings:
                    head.tie_embeddings()

    @classmethod
    def config_path(cls):
        return "configs/models/mmf_transformer/defaults.yaml"

    @classmethod
    def format_state_key(cls, key: str) -> str:
        if key.startswith("pooler.") or key.startswith("classifier."):
            return key.replace("pooler.", "heads.0.pooler.").replace(
                "classifier.", "heads.0.classifier.")
        return key

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.modalities:
            if hasattr(self, m.get("_encoder", "")):
                getattr(self, m["_encoder"]).eval()
        return self

    def _build_encoder(self, m):
        if not hasattr(self, m["_encoder"]):
            self.add_module(m["_encoder"],
                            build_image_encoder(m["encoder"]).eval())
        return getattr(self, m["_encoder"])

    def materialize_from_state_dict(self, state_dict):
        """Build the image encoders a state dict holds weights of."""
        for m in self.modalities:
            name = m.get("_encoder")
            if name and not hasattr(self, name) and any(
                    k.startswith(name + ".") or k.startswith(
                        "model." + name + ".") for k in state_dict):
                self._build_encoder(m)

    def _modality_input(self, m, sample_list):
        """A modality's raw input (reference ``_infer_input_ids``): token
        ids, an image's grid features, or [B, N, D] features."""
        key = m["key"]
        if m["type"] == "text":
            return sample_list[key] if key in sample_list else \
                sample_list["input_ids"]
        if "_encoder" in m and key in sample_list and \
                sample_list[key].dim() == 4:
            if not hasattr(self, m["_encoder"]):
                raise RuntimeError(
                    f"{m['_encoder']} is not built: call materialize(batch) "
                    "with a 4-D image before the first forward")
            return getattr(self, m["_encoder"])(sample_list[key])
        if key in sample_list:
            x = sample_list[key]
        elif f"{key}_feature_0" in sample_list:
            x = sample_list[f"{key}_feature_0"]
        else:
            x = sample_list["image_feature_0"]
        return x[:, None, :] if x.dim() == 2 else x

    @torch.no_grad()
    def materialize(self, sample_list: Dict[str, Any]):
        """Size the feature projections and position tables (and the
        heads' data-sized layers) from a batch, as flax does at init."""
        first = {k: v[:1] if isinstance(v, torch.Tensor) else v
                 for k, v in sample_list.items()}
        for idx, m in enumerate(self.modalities):
            image = first.get(m["key"])
            if "_encoder" in m and image is not None and image.dim() == 4:
                self._build_encoder(m)
            raw = self._modality_input(m, first)
            if m["type"] != "text":
                getattr(self, f"token_proj_{idx}").materialize(
                    raw.shape[-1])
            getattr(self, f"pos_embeddings_{idx}").materialize(raw.shape[1])
        return super().materialize(sample_list)

    def forward(self, sample_list: Dict[str, Any]):
        embeddings: List[torch.Tensor] = []
        masks, mlm_labels = [], []
        for idx, m in enumerate(self.modalities):
            raw = self._modality_input(m, sample_list)
            if m["type"] == "text":
                tok = getattr(self, f"token_embeddings_{idx}")(raw.long())
                mask = sample_list.get("input_mask")
                labels = sample_list.get("lm_label_ids")
            else:
                tok = getattr(self, f"token_proj_{idx}")(raw)
                tok = getattr(self, f"token_proj_ln_{idx}")(tok)
                mask = sample_list.get(f"{m['key']}_mask")
                labels = None
            device = tok.device
            if mask is None:
                mask = torch.ones(tok.shape[:2], dtype=torch.int32,
                                  device=device)
            if labels is None:
                labels = torch.full(tok.shape[:2], -1, dtype=torch.int32,
                                    device=device)
            mlm_labels.append(labels)
            pos_table = getattr(self, f"pos_embeddings_{idx}")
            if isinstance(pos_table, _PositionTable):
                pos_table.materialize(tok.shape[1])
            emb = tok + pos_table(torch.arange(tok.shape[1],
                                               device=device)[None])
            seg = m.get("segment_id", -1)
            if seg != -1:
                emb = emb + self.token_type_embeddings(torch.full(
                    tok.shape[:2], seg, dtype=torch.long, device=device))
            emb = getattr(self, f"layer_norm_{idx}")(emb)
            embeddings.append(getattr(self, f"dropout_{idx}")(emb))
            masks.append(mask)
        x = torch.cat(embeddings, 1)
        bias = make_attention_bias(torch.cat(masks, 1), self.tcfg.dtype)
        sequence = self.encoder(x, bias)

        sl = dict(sample_list)
        sl["mlm_labels"] = {"combined_labels": torch.cat(
            [lab.to(mlm_labels[0].dtype) for lab in mlm_labels], 1)}
        sl.setdefault("itm_labels", {"is_correct": sl.get(
            "is_correct", torch.ones(x.shape[0], dtype=torch.int32,
                                     device=x.device))})
        outputs: Dict[str, Any] = {"losses": {}}
        dataset = sl.get("dataset_name", "unknown")
        shared = getattr(self, self.text_table).weight if self.tie else None
        for name in self.heads_dict.names_for(dataset):
            head = self.heads_dict.heads[name]
            kwargs = {"shared_embedding": shared} if (
                shared is not None and head.ties_embeddings) else {}
            out = head(sequence, processed_sample_list=sl, **kwargs)
            for k, v in out.items():
                if k == "losses":
                    outputs["losses"].update(v)
                else:
                    outputs[k] = v
        if outputs["losses"]:
            dt = sl.get("dataset_type", "train")
            outputs["losses"] = {f"{dt}/{dataset}/{k}": v
                                 for k, v in outputs["losses"].items()}
        else:
            outputs.pop("losses")
        return outputs
