"""The transformer-heads framework: heads chosen per dataset over a
shared sequence output.

Port of ``mmf_tpu/models/transformers/base.py``. A transformer model
(ViLT, MMFTransformer) encodes its modalities into one sequence and hands
it to the heads its config names (``mlm``, ``itm``, ``mlp``, ...); each
head returns ``{"scores": ...}`` and/or ``{"losses": {...}}``.

flax builds the heads without names inside the model's compact scope,
so their parameters live under ``MLPHead_0``, ``ITM_0``, ... : the class
name and a counter per class, in construction order. ``build_heads_dict``
gives each head that name (``HeadsDict.scopes``), and the model registers
the head under it, so ``params_from_jax`` and the JAX converter see the
same paths. The backend half of the JAX module
(``BaseTransformerBackend``) has no caller in the port yet.
"""

from __future__ import annotations

from typing import Any, Dict, List

from torch import nn

from mmf_tpu_torch.common.registry import registry
from mmf_tpu_torch.models.base_model import BaseModel


class BaseTransformerHead(nn.Module):
    """A head: ``forward(sequence_output, processed_sample_list)`` ->
    ``{"scores": ...}`` and/or ``{"losses": {name: scalar}}``
    (reference base.py:380-411). ``ties_embeddings`` heads take the
    caller's token table as ``shared_embedding``."""

    ties_embeddings = False

    def __init__(self, config: Any = None):
        super().__init__()
        self.config = dict(config or {})

    def get(self, key, default=None):
        return self.config.get(key, default)

    def materialize(self, sample_list: Dict[str, Any]) -> None:
        """Size the layers whose width flax takes from the data."""


class HeadsDict:
    """Per-dataset head dispatch (reference heads/utils.py
    build_heads_dict).

    ``heads`` is {head name: module}; ``head_names`` is a list (every
    dataset) or {dataset: [head names]}; ``losses`` maps a loss key to
    its registered type; ``head_loss_names`` maps a head to the loss key
    applied to its scores; ``scopes`` maps a head to flax's module name."""

    def __init__(self, heads: Dict[str, nn.Module], head_names,
                 losses=None, head_loss_names=None, scopes=None):
        self.heads = heads
        self.head_names = head_names
        # list-style losses belong to the trainer's Losses container
        if not hasattr(losses, "keys"):
            losses = {}
        self.losses = dict(losses or {})
        self.head_loss_names = dict(head_loss_names or {})
        self.scopes = dict(scopes or {})
        self._loss_fns: Dict[str, Any] = {}

    def names_for(self, dataset_name: str) -> List[str]:
        if isinstance(self.head_names, dict):
            return list(self.head_names.get(dataset_name, []))
        return list(self.head_names)

    def _loss_fn(self, loss_key: str):
        """The registered loss a head declares, built on first use."""
        if loss_key not in self._loss_fns:
            loss_type = self.losses.get(loss_key)
            if loss_type is None:
                raise ValueError(
                    f"Head declares loss '{loss_key}' but model_config."
                    f"losses has no such key")
            if isinstance(loss_type, dict) or hasattr(loss_type, "keys"):
                cls = registry.get_loss_class(loss_type["type"])
                self._loss_fns[loss_key] = cls(
                    **dict(loss_type.get("params", {}) or {}))
            else:
                self._loss_fns[loss_key] = registry.get_loss_class(
                    loss_type)()
        return self._loss_fns[loss_key]

    def __call__(self, dataset_name, sequence_output, sample_list):
        outputs: Dict[str, Any] = {"losses": {}}
        for name in self.names_for(dataset_name):
            out = self.heads[name](sequence_output,
                                   processed_sample_list=sample_list)
            if not isinstance(out, dict):
                out = {"scores": out}
            if "losses" in out:
                outputs["losses"].update(out["losses"])
            else:
                # a head that returns scores gets its declared loss
                # (reference heads/utils.py _process_head_output)
                loss_key = self.head_loss_names.get(name)
                if loss_key is not None and "targets" in sample_list:
                    outputs["losses"][loss_key] = self._loss_fn(loss_key)(
                        sample_list, {"scores": out["scores"]})
            for k, v in out.items():
                if k != "losses":
                    outputs[k] = v
        if not outputs["losses"]:
            outputs.pop("losses")
        return outputs


def flax_ordered_heads(head_configs, model_config):
    """Per-dataset head configs in the order flax builds them: a model
    config that is not a plain dict (a ``ConfigNode``) reaches the flax
    module flattened as a pytree, which sorts mapping keys, so the
    datasets' heads are built, and named, in sorted dataset order."""
    if hasattr(head_configs, "keys") and type(model_config) is not dict:
        return {k: head_configs[k] for k in sorted(head_configs)}
    return head_configs


def build_head(head_config) -> nn.Module:
    head_type = head_config.get("type", "mlp")
    head_cls = registry.get_transformer_head_class(head_type)
    if head_cls is None:
        raise ValueError(f"No transformer head '{head_type}' registered")
    return head_cls(config=dict(head_config))


def build_heads_dict(head_configs, tasks=None, losses=None) -> HeadsDict:
    """(reference heads/utils.py:24-120) ``head_configs`` is a list of
    head configs (every dataset) or {dataset: [head configs]}; a head is
    named by ``head_name`` or its type, ``name_N`` on a clash, and its
    flax scope is its class name with a counter per class."""
    heads: Dict[str, nn.Module] = {}
    head_loss_names: Dict[str, Any] = {}
    scopes: Dict[str, str] = {}
    counters: Dict[str, int] = {}

    def register(hc, idx):
        name = hc.get("head_name", hc.get("type", f"head_{idx}"))
        if name in heads:
            name = f"{name}_{idx}"
        heads[name] = build_head(hc)
        cls_name = type(heads[name]).__name__
        scopes[name] = f"{cls_name}_{counters.get(cls_name, 0)}"
        counters[cls_name] = counters.get(cls_name, 0) + 1
        head_loss_names[name] = hc.get("loss", None)
        return name

    if isinstance(head_configs, (list, tuple)):
        names = [register(hc, i) for i, hc in enumerate(head_configs)]
        return HeadsDict(heads, names, losses, head_loss_names, scopes)

    head_names: Dict[str, List[str]] = {}
    for dataset, hcs in (head_configs or {}).items():
        if isinstance(hcs, dict) or hasattr(hcs, "keys"):
            hcs = [hcs]
        head_names[dataset] = [register(hc, i) for i, hc in enumerate(hcs)]
    return HeadsDict(heads, head_names, losses, head_loss_names, scopes)


class BaseTransformer(BaseModel):
    """Model-side contract (reference base.py:57-290): bias and
    LayerNorm parameters are exempt from weight decay."""

    def get_weight_decay_mask(self, config=None):
        from mmf_tpu_torch.utils.modeling import bert_no_decay_mask

        return bert_no_decay_mask()

    def add_heads(self, heads_dict: HeadsDict) -> HeadsDict:
        """Register every head under its flax scope name."""
        for name, head in heads_dict.heads.items():
            self.add_module(heads_dict.scopes[name], head)
        return heads_dict

    def materialize(self, sample_list: Dict[str, Any]):
        """Size the heads' data-sized layers from a batch."""
        for module in self.modules():
            if isinstance(module, BaseTransformerHead):
                module.materialize(sample_list)
        return self
