"""Process-group helpers.

Port of the part of ``mmf_tpu/utils/distributed.py`` that the
checkpoint layer and ``mmf_run`` use: ``get_rank``, ``get_world_size``,
``is_main`` and ``synchronize``, over ``torch.distributed`` when a
process group is initialised and trivial when none is (one process);
``infer_init_method``, ``suppress_output``, and the object <-> byte
array codec (``object_to_byte_tensor`` / ``byte_tensor_to_object``) that
carries strings (ids, OCR tokens, answers) through fixed-shape batches.
The rest of that module (broadcasts, gathers, the mesh) is not ported
yet.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Any

import numpy as np
import torch.distributed as dist

MAX_SIZE_LIMIT = 65533
BYTE_SIZE = 256


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main(local: bool = False) -> bool:
    return get_rank() == 0


def synchronize(message: str = "sync-workers"):
    """A barrier across the process group; ``message`` names it in
    logs only (JAX's ``sync_global_devices`` takes a tag)."""
    if get_world_size() == 1:
        return
    dist.barrier()


def infer_init_method(config):
    """``distributed.init_method`` from the torchrun variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) when all
    four are set; left as it is otherwise (one process)."""
    if config["distributed"].get("init_method", None) is not None:
        return
    if all(key in os.environ
           for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        config["distributed"]["init_method"] = "env://"
        config["distributed"]["world_size"] = int(os.environ["WORLD_SIZE"])
        config["distributed"]["rank"] = int(os.environ["RANK"])


def suppress_output(is_main_proc: bool):
    """Mute print and warnings on a process that is not the main one,
    unless called with ``force=True`` (reference distributed.py:393-430)."""
    if is_main_proc:
        return
    import builtins

    builtin_print = builtins.print

    def print_(*args, **kwargs):
        if kwargs.pop("force", False):
            builtin_print(*args, **kwargs)

    builtins.print = print_
    builtin_warn = warnings.warn

    def warn(*args, **kwargs):
        if kwargs.pop("force", False):
            builtin_warn(*args, **kwargs)

    warnings.warn = warn


def object_to_byte_tensor(obj: Any, max_size: int = 4094) -> np.ndarray:
    """``obj`` pickled into a uint8 array of ``max_size + 2``: two bytes
    of length (big end first), the pickle, zeros (reference
    distributed.py:245-262)."""
    assert max_size <= MAX_SIZE_LIMIT
    byte_arr = pickle.dumps(obj)
    obj_size = len(byte_arr)
    if obj_size > max_size:
        raise Exception(
            f"objects too large: object size {obj_size}, max size {max_size}"
        )
    byte_tensor = np.zeros(max_size + 2, dtype=np.uint8)
    byte_tensor[0] = obj_size // BYTE_SIZE
    byte_tensor[1] = obj_size % BYTE_SIZE
    byte_tensor[2:2 + obj_size] = np.frombuffer(byte_arr, dtype=np.uint8)
    return byte_tensor


def byte_tensor_to_object(byte_tensor, max_size: int = 4094) -> Any:
    """The object that ``object_to_byte_tensor`` packed (a numpy array or
    a CPU tensor)."""
    byte_tensor = np.asarray(byte_tensor, dtype=np.uint8)
    assert byte_tensor.ndim == 1 and byte_tensor.shape[0] <= max_size + 2
    obj_size = int(byte_tensor[0]) * BYTE_SIZE + int(byte_tensor[1])
    return pickle.loads(byte_tensor[2:2 + obj_size].tobytes())
