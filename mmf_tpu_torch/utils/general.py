"""General training helpers.

Port of the JAX-free helper ``mmf_tpu/utils/general.py::
clip_gradients_config`` (the port keeps its own copy; the rest of that
module is not ported yet).
"""

from __future__ import annotations

from typing import Optional


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
