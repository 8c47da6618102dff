"""Process-group helpers the checkpoint layer calls.

Port of the part of ``mmf_tpu/utils/distributed.py`` that
``utils/checkpoint.py`` uses: ``get_rank``, ``get_world_size``,
``is_main`` and ``synchronize``, over ``torch.distributed`` when a
process group is initialised and trivial when none is (one process).
The rest of that module (broadcasts, gathers, the mesh) is not ported
yet.
"""

from __future__ import annotations

import torch.distributed as dist


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
