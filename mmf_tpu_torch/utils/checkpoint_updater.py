"""Weights carried across from the JAX package and from reference MMF
checkpoints.

``params_from_jax`` maps a flax ``variables["params"]`` tree (as numpy
arrays) onto the port's ``state_dict``. The port's parameter names mirror
the flax paths with dots, so the mapping is mechanical:

- Dense ``kernel`` [in, out]  -> ``weight`` [out, in] (transposed)
- Conv ``kernel`` [H, W, I, O] -> ``weight`` [O, I, H, W]; a 1-D Conv's
  [W, I, O] stays as it is (``modules/embeddings.py::Conv1d`` keeps
  flax's layout, which JAX's ``convert_torch_state_dict`` takes back
  untransposed)
- Embed ``embedding``         -> ``weight``
- LayerNorm/BatchNorm ``scale`` -> ``weight``
- ``bias``                    -> ``bias``
- a parameter made with ``self.param`` outside those modules (the ViT
  patch embeddings' ``cls_token`` and ``position_embeddings``, BAN's
  ``BCNet`` ``h_mat`` and ``h_bias``) keeps its name
- a ``WeightNorm`` wrapper's gain (``fc1/{Dense_0/kernel/scale}``, flax
  names it after the wrapped kernel) keeps its name:
  ``fc1.Dense_0/kernel/scale`` (``modules/layers.py::WeightNormGain``)
- an LSTM cell's products (``ii`` ... ``ho``) and a GRU cell's (``ir``
  ... ``hn``) are Dense layers

A module that flax applies more than once holds one scope, and so one
parameter here: UNITER's token-type table, which its image stream reads
from the text stream's; LXMERT's cross-attention module, applied both
ways in each cross layer; VinVL's trunk, run again on the corrupted
pair. Each maps once by the same rule.

and, from a ``variables["batch_stats"]`` tree, BatchNorm ``mean`` ->
``running_mean`` and ``var`` -> ``running_var``, with a zero
``num_batches_tracked`` beside them (flax keeps no such counter), so
``load_state_dict(strict=True)`` takes the result.

``convert_reference_state_dict`` maps a reference-named torch state_dict
(``model.bert.encoder.layer.0.attention.self.query.weight``, ...) onto
the port's names. It is the JAX package's ``convert_torch_state_dict``
with the port's naming as its target: the same key maps (regex renames,
then the model's ``format_state_key``), the same leaf rules (LayerNorm
``weight`` -> scale, Linear and Embedding ``weight`` -> kernel or
embedding, BatchNorm leaves verbatim), the same fuzzy match (lower case,
underscores dropped) and the same ``matched / missed / shape_mismatch``
counts. Both sides keep torch's layout, so nothing is transposed; a key
that is already one of the port's names is taken as it is.
``reference_key_map(model)`` composes the maps as the JAX package's
``tools/scripts/convert_checkpoint.py`` does. The port keeps its own copy
of the maps, for the families it has.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_VERBATIM = {"cls_token", "position_embeddings", "classifier_w",
             "classifier_b", "h_mat", "h_bias"}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def params_from_jax(
    params: Any, batch_stats: Optional[Any] = None
) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree (nested dicts of arrays), and optionally its
    ``batch_stats`` tree -> port ``state_dict``."""
    state: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        if key in state:
            raise KeyError(f"two flax leaves map onto {key}")
        # np.array keeps a 0-d array 0-d (ascontiguousarray makes it 1-d)
        state[key] = torch.from_numpy(np.array(arr, order="C", copy=True))

    for path, value in _flatten(params).items():
        leaf = path[-1]
        arr = np.asarray(value)
        if leaf in _VERBATIM:
            put(".".join(path), arr)
            continue
        if leaf.endswith("/kernel/scale"):  # a WeightNorm wrapper's gain
            put(".".join(path), arr)
            continue
        if leaf not in _LEAF:
            raise KeyError(f"no port mapping for flax leaf {'/'.join(path)}")
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3:
                pass  # a Conv1d keeps flax's [W, I, O] (modules/embeddings.py)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            else:
                raise ValueError(
                    f"{'/'.join(path)}: only 2-D Dense and 3-D or 4-D Conv kernels "
                    f"map, got shape {arr.shape}"
                )
        put(".".join(path[:-1] + (_LEAF[leaf],)), arr)
    for path, value in _flatten(batch_stats or {}).items():
        leaf = path[-1]
        if leaf not in _STATS:
            raise KeyError(
                f"no port mapping for flax batch_stats leaf {'/'.join(path)}")
        put(".".join(path[:-1] + (_STATS[leaf],)), np.asarray(value))
        if leaf == "mean":
            put(".".join(path[:-1] + ("num_batches_tracked",)),
                np.zeros((), np.int64))
    return state


def is_model_only_checkpoint(ckpt: Dict[str, Any]) -> bool:
    """(reference checkpoint_updater.py:21)"""
    return "model" in ckpt and "optimizer" not in ckpt


def get_pretrained_state_mapping_checkpoint(checkpoint, model, mapping):
    """(reference checkpoint_updater.py:62): filter a checkpoint down to
    keys covered by the pretrained_state_mapping."""
    out = {}
    for own_attr, pretrained_attr in mapping.items():
        for key, value in checkpoint.items():
            if key.startswith(pretrained_attr):
                out[key.replace(pretrained_attr, own_attr, 1)] = value
    return out


# canonical rename maps (HF BERT -> the shared trunk's names)
HF_BERT_KEY_MAP = {
    r"embeddings\.word_embeddings": "embeddings.word_embeddings",
    r"embeddings\.LayerNorm": "embeddings.layer_norm",
    r"encoder\.layer\.(\d+)\.attention\.self\.query":
        r"encoder.layer_\1.attention.query",
    r"encoder\.layer\.(\d+)\.attention\.self\.key":
        r"encoder.layer_\1.attention.key",
    r"encoder\.layer\.(\d+)\.attention\.self\.value":
        r"encoder.layer_\1.attention.value",
    r"encoder\.layer\.(\d+)\.attention\.output\.dense":
        r"encoder.layer_\1.attention.output_dense",
    r"encoder\.layer\.(\d+)\.attention\.output\.LayerNorm":
        r"encoder.layer_\1.attention.output_layer_norm",
    r"encoder\.layer\.(\d+)\.intermediate\.dense":
        r"encoder.layer_\1.ffn.intermediate_dense",
    r"encoder\.layer\.(\d+)\.output\.dense":
        r"encoder.layer_\1.ffn.output_dense",
    r"encoder\.layer\.(\d+)\.output\.LayerNorm":
        r"encoder.layer_\1.ffn.output_layer_norm",
    r"pooler\.dense": "pooler.dense",
}

# MMBT zoo checkpoints (MMBTModel: shared-embedding multimodal BERT)
MMBT_KEY_MAP = {
    r"transformer\.embeddings\.word_embeddings": "word_embeddings",
    r"transformer\.embeddings\.position_embeddings": "position_embeddings",
    r"transformer\.embeddings\.token_type_embeddings":
        "token_type_embeddings",
    r"transformer\.embeddings\.LayerNorm": "embeddings_layer_norm",
    r"transformer\.encoder": "encoder",
    r"transformer\.pooler\.dense": "pooler.dense",
    r"modal_encoder\.proj_embeddings": "proj_embeddings",
    r"modal_encoder\.word_embeddings": "word_embeddings",
    r"modal_encoder\.position_embeddings": "position_embeddings",
    r"modal_encoder\.token_type_embeddings": "token_type_embeddings",
    r"modal_encoder\.LayerNorm": "embeddings_layer_norm",
}

VISUAL_BERT_KEY_MAP = {
    # NSP head: torch key cls.seq_relationship -> a top-level module here
    r"cls\.seq_relationship": "seq_relationship",
}

# ViLBERT zoo checkpoints (trunk under "bert."): the two-stream layers'
# names onto the port's (models/vilbert.py). The patterns are unanchored,
# so the same map works under wrapper prefixes.
VILBERT_KEY_MAP = {
    # pretraining ITM head (reference vilbert.py:865 bi_seq_relationship
    # lives under cls.)
    r"cls\.bi_seq_relationship": "bi_seq_relationship",
    r"bert\.encoder\.layer\.(\d+)\.attention\.self\.": r"bert.layer_\1.",
    r"bert\.encoder\.layer\.(\d+)\.attention\.output\.dense":
        r"bert.layer_\1.attention_output_dense",
    r"bert\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm":
        r"bert.layer_\1.attention_ln",
    r"bert\.encoder\.layer\.(\d+)\.intermediate\.dense":
        r"bert.layer_\1.intermediate_dense",
    r"bert\.encoder\.layer\.(\d+)\.output\.dense":
        r"bert.layer_\1.output_dense",
    r"bert\.encoder\.layer\.(\d+)\.output\.LayerNorm":
        r"bert.layer_\1.output_ln",
    r"bert\.encoder\.v_layer\.(\d+)\.attention\.self\.":
        r"bert.v_layer_\1.attention_self.",
    r"bert\.encoder\.v_layer\.(\d+)\.attention\.output\.dense":
        r"bert.v_layer_\1.attention_output_dense",
    r"bert\.encoder\.v_layer\.(\d+)\.attention\.output\.LayerNorm":
        r"bert.v_layer_\1.attention_ln",
    r"bert\.encoder\.v_layer\.(\d+)\.intermediate\.dense":
        r"bert.v_layer_\1.intermediate_dense",
    r"bert\.encoder\.v_layer\.(\d+)\.output\.dense":
        r"bert.v_layer_\1.output_dense",
    r"bert\.encoder\.v_layer\.(\d+)\.output\.LayerNorm":
        r"bert.v_layer_\1.output_ln",
    r"bert\.encoder\.c_layer\.(\d+)\.biattention\.": r"bert.c_layer_\1.",
    r"bert\.encoder\.c_layer\.(\d+)\.biOutput\.dense1":
        r"bert.c_layer_\1.biout_dense1",
    r"bert\.encoder\.c_layer\.(\d+)\.biOutput\.LayerNorm1":
        r"bert.c_layer_\1.biout_ln1",
    r"bert\.encoder\.c_layer\.(\d+)\.biOutput\.dense2":
        r"bert.c_layer_\1.biout_dense2",
    r"bert\.encoder\.c_layer\.(\d+)\.biOutput\.LayerNorm2":
        r"bert.c_layer_\1.biout_ln2",
    r"bert\.encoder\.c_layer\.(\d+)\.v_intermediate\.dense":
        r"bert.c_layer_\1.v_intermediate",
    r"bert\.encoder\.c_layer\.(\d+)\.v_output\.dense":
        r"bert.c_layer_\1.v_output",
    r"bert\.encoder\.c_layer\.(\d+)\.v_output\.LayerNorm":
        r"bert.c_layer_\1.v_output_ln",
    r"bert\.encoder\.c_layer\.(\d+)\.t_intermediate\.dense":
        r"bert.c_layer_\1.t_intermediate",
    r"bert\.encoder\.c_layer\.(\d+)\.t_output\.dense":
        r"bert.c_layer_\1.t_output",
    r"bert\.encoder\.c_layer\.(\d+)\.t_output\.LayerNorm":
        r"bert.c_layer_\1.t_output_ln",
    r"bert\.v_embeddings\.image_embeddings": "bert.v_image_embeddings",
    r"bert\.v_embeddings\.image_location_embeddings":
        "bert.v_location_embeddings",
    r"bert\.v_embeddings\.LayerNorm": "bert.v_embeddings_ln",
    r"bert\.embeddings\.LayerNorm": "bert.embeddings.layer_norm",
    r"bert\.t_pooler\.dense": "bert.t_pooler",
    r"bert\.v_pooler\.dense": "bert.v_pooler",
}

# HF ViT -> the pre-LN ViTModel (modules/vit.py)
HF_VIT_KEY_MAP = {
    r"^vit\.": "",
    r"embeddings\.patch_embeddings\.projection": "embeddings.projection",
    r"encoder\.layer\.(\d+)\.layernorm_before":
        r"encoder.layer_\1.layernorm_before",
    r"encoder\.layer\.(\d+)\.layernorm_after":
        r"encoder.layer_\1.layernorm_after",
    r"encoder\.layer\.(\d+)\.attention\.attention\.query":
        r"encoder.layer_\1.attention_query",
    r"encoder\.layer\.(\d+)\.attention\.attention\.key":
        r"encoder.layer_\1.attention_key",
    r"encoder\.layer\.(\d+)\.attention\.attention\.value":
        r"encoder.layer_\1.attention_value",
    # older HF versions nest self-attention one level less
    r"encoder\.layer\.(\d+)\.attention\.self\.query":
        r"encoder.layer_\1.attention_query",
    r"encoder\.layer\.(\d+)\.attention\.self\.key":
        r"encoder.layer_\1.attention_key",
    r"encoder\.layer\.(\d+)\.attention\.self\.value":
        r"encoder.layer_\1.attention_value",
    r"encoder\.layer\.(\d+)\.attention\.output\.dense":
        r"encoder.layer_\1.attention_output_dense",
    r"encoder\.layer\.(\d+)\.intermediate\.dense":
        r"encoder.layer_\1.intermediate_dense",
    r"encoder\.layer\.(\d+)\.output\.dense": r"encoder.layer_\1.output_dense",
    r"^layernorm\.": "layernorm.",
    r"^pooler\.dense": "pooler.dense",
}

# the families the port has (mmf_transformer / mmft and the others
# not named here take the HF-BERT patterns and the fuzzy match)
MODEL_KEY_MAPS: Dict[str, Dict[str, str]] = {
    "visual_bert": VISUAL_BERT_KEY_MAP,
    "mmbt": MMBT_KEY_MAP,
    "vilbert": VILBERT_KEY_MAP,
    "vilt": HF_VIT_KEY_MAP,
}


def reference_key_map(model_name: Optional[str]) -> Dict[str, str]:
    """The renames for a reference MMF state_dict of ``model_name``, in
    the JAX converter CLI's order: the ``model.`` wrapper prefix
    stripped, the family's map, then the HF-BERT patterns."""
    key_map = {r"^model\.": ""}
    key_map.update(MODEL_KEY_MAPS.get(model_name, {}))
    key_map.update(HF_BERT_KEY_MAP)
    return key_map


def _torch_key_to_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """A torch dotted key -> (module path, kind), kind in {kernel, bias,
    scale, other} (the JAX converter's ``_torch_key_to_flax_path``)."""
    parts = key.split(".")
    leaf = parts[-1]
    body = parts[:-1]
    body_l = [p.lower() for p in body]
    if body and ("layernorm" in body_l[-1] or "layer_norm" in body_l[-1]
                 or body[-1] == "LayerNorm"):
        return tuple(body), "scale" if leaf == "weight" else "bias"
    if body and re.fullmatch(r"bn\d*|.*batch_?norm\d*", body_l[-1]):
        return tuple(body + [leaf]), "other"
    if leaf == "weight":
        return tuple(body), "kernel"
    if leaf == "bias":
        return tuple(body), "bias"
    return tuple(body + [leaf]), "other"


# the port's leaf for each kind: flax's kernel, embedding and scale are
# all torch's ``weight``
_KIND_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _normalise(path) -> Tuple[str, ...]:
    return tuple(p.lower().replace("_", "") for p in path)


def convert_reference_state_dict(
    state_dict: Dict[str, Any],
    own_state: Dict[str, torch.Tensor],
    key_map: Optional[Dict[str, str]] = None,
    format_state_key=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Name-matched conversion of ``state_dict`` onto the port's
    ``own_state`` names: (the matched entries under the port's names, in
    ``own_state``'s dtypes, and the counts)."""
    key_map = key_map or {}
    index = {_normalise(k.split(".")): k for k in own_state}
    stats = {"matched": 0, "missed": 0, "shape_mismatch": 0}
    out: Dict[str, torch.Tensor] = {}
    for tkey, value in state_dict.items():
        target = tkey if tkey in own_state else None
        if target is None:
            key = tkey
            for pattern, repl in key_map.items():
                key = re.sub(pattern, repl, key)
            if format_state_key is not None:
                key = format_state_key(key)
            path, kind = _torch_key_to_path(key)
            if kind in _KIND_LEAF:
                path = path + (_KIND_LEAF[kind],)
            target = index.get(_normalise(path))
        if target is None:
            stats["missed"] += 1
            continue
        value = torch.as_tensor(value)
        own = own_state[target]
        # a lazily sized layer (``LazyDense``) takes the entry's shape
        if not isinstance(own, torch.nn.UninitializedParameter) and \
                tuple(value.shape) != tuple(own.shape):
            stats["shape_mismatch"] += 1
            continue
        out[target] = value.to(own.dtype)
        stats["matched"] += 1
    logger.info(
        f"reference -> port conversion: {stats['matched']} matched, "
        f"{stats['missed']} missed, {stats['shape_mismatch']} shape "
        "mismatches"
    )
    return out, stats
