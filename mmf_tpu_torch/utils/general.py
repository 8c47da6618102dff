"""General training helpers.

Port of the parts of ``mmf_tpu/utils/general.py`` that the training path
calls: ``clip_gradients_config``, ``get_batch_size``, ``get_max_updates``,
``extract_loss`` and ``get_absolute_path``.
"""

from __future__ import annotations

import collections.abc
import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def clip_gradients_config(config) -> Optional[float]:
    """The max global gradient norm the train step clips to, or None when
    ``training.clip_gradients`` is off or no ``max_grad_l2_norm`` is set."""
    training = config["training"]
    if not training.get("clip_gradients", False):
        return None
    max_grad_l2_norm = training.get("max_grad_l2_norm", None)
    if max_grad_l2_norm is None:
        return None
    return float(max_grad_l2_norm)


def get_batch_size(config=None) -> int:
    """The per-process batch: ``training.batch_size`` over the world size
    (``batch_size_per_device`` wins when set; one device a process)."""
    from mmf_tpu_torch.config.configuration import get_global_config
    from mmf_tpu_torch.utils.distributed import get_world_size

    if config is None:
        config = get_global_config()
    training = config["training"]
    per_device = training.get("batch_size_per_device", None)
    if per_device is not None:
        return int(per_device)
    batch_size = training["batch_size"]
    world_size = get_world_size()
    if batch_size % world_size != 0:
        raise RuntimeError(
            f"Batch size {batch_size} must be divisible by number of "
            f"processes {world_size}"
        )
    return batch_size // world_size


def get_max_updates(config_max_updates, config_max_epochs, train_loader,
                    update_frequency):
    """Epoch <-> update conversion (reference general.py:337-368). One
    loader batch is one optimizer update: ``update_frequency`` splits the
    batch into microbatches inside the train step, so epochs convert to
    updates without dividing by it."""
    del update_frequency
    if config_max_updates is None and config_max_epochs is None:
        raise ValueError("Neither max_updates nor max_epochs is specified.")

    if config_max_updates is not None and config_max_epochs is not None:
        logger.warning(
            "Both max_updates and max_epochs are specified. "
            f"Favoring max_epochs: {config_max_epochs}"
        )

    if config_max_epochs is not None:
        if not hasattr(train_loader, "__len__") or len(train_loader) == 0:
            raise ValueError("max_epochs can't be used with IterableDatasets")
        max_updates = int(len(train_loader) * config_max_epochs)
        max_epochs = config_max_epochs
    else:
        max_updates = config_max_updates
        if hasattr(train_loader, "__len__") and len(train_loader) != 0:
            max_epochs = max_updates / len(train_loader)
        else:
            max_epochs = float("inf")
    return max_updates, max_epochs


def extract_loss(report_or_losses, loss_divisor: int = 1):
    """The sum of the losses' means over the accumulation count
    (reference general.py:370-380)."""
    losses = (
        report_or_losses["losses"]
        if isinstance(report_or_losses, collections.abc.Mapping)
        and "losses" in report_or_losses
        else report_or_losses
    )
    loss = sum(v.mean() for v in losses.values())
    return loss / loss_divisor


def get_absolute_path(paths):
    """``paths`` as given when they exist, else under ``env.data_dir``,
    else under the repository root; lists map element-wise."""
    from mmf_tpu_torch.config.configuration import get_mmf_env, get_repo_root

    if isinstance(paths, str):
        if os.path.isabs(paths):
            return paths
        possible_paths = [paths]
        data_dir = get_mmf_env(key="data_dir")
        if data_dir:
            possible_paths.append(os.path.join(data_dir, paths))
        possible_paths.append(os.path.join(get_repo_root(), paths))
        for p in possible_paths:
            if os.path.exists(p):
                return p
        return os.path.join(data_dir, paths) if data_dir else paths
    if isinstance(paths, collections.abc.Iterable):
        return [get_absolute_path(p) for p in paths]
    raise TypeError("Paths passed to dataset should either be string or list")
