"""Edit distance and ANLS for the M4C answer metrics.

Port of ``mmf_tpu/utils/native/editdist.py``: the C kernels of
``src/editdist.c`` (a two-row Levenshtein DP over bytes, lengths clamped
to 511, and the best thresholded similarity of one prediction over its
ground truths), compiled at first use by ``utils/native/build.py``, which
raises where no C compiler works. The C kernel is byte-level, so any
string that is not ASCII goes to the character-level DP here, and
distances stay distances between characters.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "src", "editdist.c"
)
_LIB: Optional[ctypes.CDLL] = None


def _setup(lib):
    lib.edit_distance.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.edit_distance.restype = ctypes.c_int
    lib.anls_best.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.anls_best.restype = ctypes.c_double


def library() -> ctypes.CDLL:
    """The kernels, built at first use; raises when they cannot be built."""
    global _LIB
    if _LIB is None:
        from mmf_tpu_torch.utils.native.build import compile_lib

        _LIB = compile_lib(_SRC, "editdist", _setup)
    return _LIB


def _edit_distance_python(s1: str, s2: str) -> int:
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        cur = [i + 1]
        for j, c2 in enumerate(s2):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (c1 != c2)))
        prev = cur
    return prev[-1]


def edit_distance(s1: str, s2: str) -> int:
    """Levenshtein distance between two strings, in characters."""
    lib = library()
    if not (s1.isascii() and s2.isascii()):
        return _edit_distance_python(s1, s2)
    return lib.edit_distance(s1.encode("utf-8"), s2.encode("utf-8"))


def anls_best(pred: str, gts: List[str]) -> float:
    """The best, over the ground truths, of the normalized Levenshtein
    similarity ``1 - distance / longer length``, with similarities under
    0.5 counted as 0 (the ANLS rule); a pair whose longer string is empty
    scores 0, and no ground truth scores 0."""
    lib = library()
    if not gts or not pred.isascii() or not all(g.isascii() for g in gts):
        best = 0.0
        for gt in gts:
            mx = max(len(pred), len(gt))
            if mx == 0:
                continue
            sim = 1.0 - _edit_distance_python(pred, gt) / mx
            best = max(best, sim if sim >= 0.5 else 0.0)
        return best
    packed = b""
    offsets = np.zeros(len(gts), np.int32)
    for i, gt in enumerate(gts):
        offsets[i] = len(packed)
        packed += gt.encode("utf-8") + b"\x00"
    return lib.anls_best(
        pred.encode("utf-8"), packed,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(gts),
    )
