"""The flagship models and their example inputs, as the port builds them.

Counterparts of ``__graft_entry__.py::_visual_bert`` and
``_example_batch``: VisualBERT through the registry and the JAX
package's ``defaults.yaml`` (VisualBERT-base: 12 x 768, 12 heads, bf16
compute) with a VQA2 classification head (3129 answers), and VQA2-shaped
inputs (128 text tokens, 100 regions of 2048-dim features) drawn from a
numpy seed.

For training: ``vqa2_config`` merges
``projects/visual_bert/configs/vqa2/defaults.yaml`` over the JAX
package's ``config/defaults.yaml`` (both read as data),
``vqa2_visual_bert`` builds the model of its ``model_config``,
``vqa2_train_batch`` adds soft VQA targets to ``example_batch``, and
``vqa2_trainer`` builds the optimizer, schedule, losses and train step
from that config, as ``MMFTrainer`` does.

For Hateful Memes at batch 1 (the JAX package's latency metric,
``tools/benchmarks/bench_latency.py``): ``mmbt_grid`` builds MMBT-grid
(ResNet-152 grid features, 12 x 768 trunk, 2 labels, bf16 compute) from
``configs/models/mmbt/defaults.yaml`` with the classification head, and
``hateful_memes_example_batch`` draws that script's inputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

VQA2_NUM_LABELS = 3129
VQA2_CONFIG = "projects/visual_bert/configs/vqa2/defaults.yaml"
VQA2_META = {"dataset_name": "vqa2", "dataset_type": "train"}
HATEFUL_MEMES_META = {"dataset_name": "hateful_memes", "dataset_type": "test"}


def visual_bert(model_overrides: Optional[Dict[str, Any]] = None):
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    cfg = load_yaml("configs/models/visual_bert/defaults.yaml")
    mc = cfg["model_config"]["visual_bert"]
    mc["training_head_type"] = "classification"
    mc["num_labels"] = VQA2_NUM_LABELS
    if model_overrides:
        mc.update(model_overrides)
    return registry.get_model_class("visual_bert")(config=mc)


def example_batch(batch_size: int = 8, seq_len: int = 128,
                  regions: int = 100, vdim: int = 2048,
                  vocab_size: int = 30522,
                  seed: int = 0) -> Dict[str, Any]:
    """Batch dict of numpy arrays in the ``_example_batch`` layout (same
    draws from ``np.random.RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(0, vocab_size,
                                 (batch_size, seq_len)).astype(np.int32),
        "input_mask": np.ones((batch_size, seq_len), np.int32),
        "segment_ids": np.zeros((batch_size, seq_len), np.int32),
        "image_feature_0": rng.randn(batch_size, regions,
                                     vdim).astype(np.float32),
        "image_info_0": {
            "max_features": np.full((batch_size,), regions, np.int32)
        },
    }


def mmbt_grid(model_overrides: Optional[Dict[str, Any]] = None):
    """MMBT-grid for Hateful Memes, as ``bench_latency.py`` builds it: the
    MMBT defaults with the classification head, 2 labels and bf16
    compute, then ``model_overrides`` (e.g. ``{"quant": "int8"}``)."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.config.configuration import load_yaml
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    cfg = load_yaml("configs/models/mmbt/defaults.yaml")
    mc = cfg["model_config"]["mmbt"]
    mc["training_head_type"] = "classification"
    mc["num_labels"] = 2
    mc["dtype"] = "bfloat16"
    mc = omega.merge(mc, model_overrides or {})
    return registry.get_model_class("mmbt")(config=mc)


def hateful_memes_example_batch(batch_size: int = 1,
                                seed: int = 0) -> Dict[str, Any]:
    """``bench_latency.py``'s inputs (same draws from
    ``np.random.RandomState(seed)``): 128 text tokens, all-ones mask,
    zero segments, a [B, 3, 224, 224] f32 image, and the
    ``hateful_memes`` meta fields."""
    rng = np.random.RandomState(seed)
    input_ids = rng.randint(0, 30522, (batch_size, 128)).astype(np.int32)
    return {
        "input_ids": input_ids,
        "input_mask": np.ones((batch_size, 128), np.int32),
        "segment_ids": np.zeros((batch_size, 128), np.int32),
        "image": rng.randn(batch_size, 3, 224, 224).astype(np.float32),
        **HATEFUL_MEMES_META,
    }


def split_samples(batch: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Batch dict -> list of per-sample dicts (one request each); fields
    that are not arrays (meta strings) go to every sample as they are."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i] if isinstance(tree, np.ndarray) else tree

    n = len(batch["input_ids"])
    return [take(batch, i) for i in range(n)]


def vqa2_config(opts: Optional[List[str]] = None):
    """The VQA2 VisualBERT config merged over the root defaults, then
    ``opts`` (``a.b.c=value`` overrides) applied."""
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.config.configuration import load_yaml

    cfg = omega.merge(load_yaml("config/defaults.yaml"),
                      load_yaml(VQA2_CONFIG))
    omega.merge_with_dotlist(cfg, list(opts or []))
    return cfg


def vqa2_visual_bert(config, model_overrides: Optional[Dict[str, Any]] = None):
    """VisualBERT from the config's ``model_config.visual_bert`` with
    ``model_overrides`` on a copy."""
    from mmf_tpu_torch.common.registry import registry
    from mmf_tpu_torch.config import omega
    from mmf_tpu_torch.utils.env import setup_imports

    setup_imports()
    mc = omega.merge(config["model_config"]["visual_bert"],
                     model_overrides or {})
    return registry.get_model_class("visual_bert")(config=mc)


def vqa2_train_batch(batch_size: int = 8, seq_len: int = 128,
                     regions: int = 100, vdim: int = 2048,
                     vocab_size: int = 30522,
                     num_labels: int = VQA2_NUM_LABELS,
                     seed: int = 0) -> Dict[str, Any]:
    """``example_batch`` plus ``targets`` [B, num_labels]: VQA soft
    scores, three answers per question at 0.3, 0.6, 0.9 or 1.0, drawn
    from ``np.random.RandomState(seed + 1)``."""
    batch = example_batch(batch_size, seq_len, regions, vdim, vocab_size,
                          seed)
    rng = np.random.RandomState(seed + 1)
    targets = np.zeros((batch_size, num_labels), np.float32)
    for i in range(batch_size):
        idx = rng.choice(num_labels, size=min(3, num_labels), replace=False)
        targets[i, idx] = rng.choice([0.3, 0.6, 0.9, 1.0], size=len(idx))
    batch["targets"] = targets
    return batch


def vqa2_trainer(model, config, seed: int = 0, device: Any = "cuda"):
    """``(state, train_step)`` for ``model``, moved to ``device``, as
    ``MMFTrainer`` builds them: the model's weight-decay mask and lr
    multipliers as optimizer groups, the configured schedule as a
    ``LambdaLR``, clipping from ``training``, the model's losses, and
    the VQA2 meta fields. Trains on the card unless the caller passes
    ``device="cpu"``; raises where there is no card."""
    import torch

    from mmf_tpu_torch.modules.optimizers import build_optimizer
    from mmf_tpu_torch.modules.schedulers import (
        build_lr_scheduler,
        build_scheduler,
    )
    from mmf_tpu_torch.trainers.core.train_state import (
        create_train_state,
        make_train_step,
    )
    from mmf_tpu_torch.utils.general import clip_gradients_config

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vqa2_trainer trains on the card by default, and this machine "
            "has no CUDA device; pass device='cpu' to train through the "
            "plain versions on the CPU"
        )
    # before the optimizer is built: its groups hold the moved parameters
    model = model.to(device)
    optimizer = build_optimizer(
        config, model, lr_multipliers=model.get_lr_multipliers(config),
        weight_decay_mask=model.get_weight_decay_mask(config),
    )
    lr_scheduler = build_lr_scheduler(optimizer, build_scheduler(config))
    step = make_train_step(
        model.build_losses(),
        update_frequency=config["training"].get("update_frequency", 1),
        max_grad_norm=clip_gradients_config(config),
        meta=VQA2_META,
    )
    return create_train_state(model, optimizer, seed, lr_scheduler), step
