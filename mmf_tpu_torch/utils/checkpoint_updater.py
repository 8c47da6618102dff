"""Weights carried across from the JAX package.

``params_from_jax`` maps a flax ``variables["params"]`` tree (as numpy
arrays) onto the port's ``state_dict``. The port's parameter names mirror
the flax paths with dots, so the mapping is mechanical:

- Dense ``kernel`` [in, out]  -> ``weight`` [out, in] (transposed)
- Conv ``kernel`` [H, W, I, O] -> ``weight`` [O, I, H, W]
- Embed ``embedding``         -> ``weight``
- LayerNorm/BatchNorm ``scale`` -> ``weight``
- ``bias``                    -> ``bias``

and, from a ``variables["batch_stats"]`` tree, BatchNorm ``mean`` ->
``running_mean`` and ``var`` -> ``running_var``, with a zero
``num_batches_tracked`` beside them (flax keeps no such counter), so
``load_state_dict(strict=True)`` takes the result.

Loading MMF/HF zoo checkpoints (composing ``HF_BERT_KEY_MAP`` of the JAX
package with this naming) waits for the checkpoint port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


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
        state[key] = torch.from_numpy(np.ascontiguousarray(arr).copy())

    for path, value in _flatten(params).items():
        leaf = path[-1]
        if leaf not in _LEAF:
            raise KeyError(f"no port mapping for flax leaf {'/'.join(path)}")
        arr = np.asarray(value)
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            else:
                raise ValueError(
                    f"{'/'.join(path)}: only 2-D Dense and 4-D Conv kernels "
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
