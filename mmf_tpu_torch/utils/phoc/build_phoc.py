"""PHOC featurizer: word -> 604-dim float vector.

Port of ``mmf_tpu/utils/phoc/build_phoc.py``. ``build_phoc`` and
``build_phoc_batch`` run the native C implementation (``src/phoc.c``),
compiled at first use by ``utils/native/build.py`` (which raises where no
C compiler works). ``build_phoc_python`` is its plain twin, the same
construction in float32 arithmetic, which the tests hold the C build
against; the featurizer never falls back to it.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

PHOC_DIM = 604
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "phoc.c")
_LIB: Optional[ctypes.CDLL] = None

_UNIGRAMS = "abcdefghijklmnopqrstuvwxyz0123456789"
_BIGRAMS = [
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el",
]


def _setup(lib):
    lib.phoc_build.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_float)]
    lib.phoc_build.restype = ctypes.c_int
    lib.phoc_build_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.phoc_build_batch.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The C featurizer, built at first use."""
    global _LIB
    if _LIB is None:
        from mmf_tpu_torch.utils.native.build import compile_lib

        _LIB = compile_lib(_SRC, "phoc", _setup)
    return _LIB


def _normalize(token: str) -> str:
    """Lowercase and strip, then keep only the 36-character alphabet, as
    the reference wrapper does (spaces and punctuation are dropped, not
    passed to the featurizer, which refuses unknown characters)."""
    return "".join(c for c in token.lower().strip() if c in _UNIGRAMS)


def build_phoc_python(token: str) -> np.ndarray:
    """The plain twin of ``src/phoc.c`` on a normalized token."""
    out = np.zeros(PHOC_DIM, np.float32)
    n = len(token)
    if n == 0:
        return out

    f32 = np.float32

    def occupies(occ0, occ1, region, level):
        # float32 arithmetic to match the C implementation exactly (the
        # 0.5 threshold sits on float32 rounding boundaries)
        occ0, occ1 = f32(occ0), f32(occ1)
        r0 = f32(f32(region) / f32(level))
        r1 = f32(f32(region + 1) / f32(level))
        o0, o1 = max(occ0, r0), min(occ1, r1)
        return f32(o1 - o0) / f32(occ1 - occ0) >= f32(0.5)

    for i, ch in enumerate(token):
        ci = _UNIGRAMS.find(ch)
        if ci < 0:
            raise ValueError(f"unigram {ch!r} is unknown")
        occ0, occ1 = i / n, (i + 1) / n
        level_offset = 0
        for level in range(2, 6):
            for region in range(level):
                if occupies(occ0, occ1, region, level):
                    out[(level_offset + region) * 36 + ci] = 1.0
            level_offset += level

    bigram_offset = 36 * 14
    for i in range(n - 1):
        pair = token[i:i + 2]
        if pair not in _BIGRAMS:
            continue
        bi = _BIGRAMS.index(pair)
        occ0, occ1 = i / n, (i + 2) / n
        for region in range(2):
            if occupies(occ0, occ1, region, 2):
                out[bigram_offset + region * 50 + bi] = 1.0
    return out


def build_phoc(token: str) -> np.ndarray:
    """One word's PHOC through the C featurizer."""
    out = np.zeros(PHOC_DIM, np.float32)
    rc = library().phoc_build(
        _normalize(token).encode("utf-8"),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"phoc_build failed on {token!r}")
    return out


def build_phoc_batch(tokens: List[str]) -> np.ndarray:
    """[len(tokens), 604] through one C call."""
    packed = bytearray()
    offsets = np.zeros(len(tokens), np.int32)
    for i, t in enumerate(tokens):
        offsets[i] = len(packed)
        packed += _normalize(t).encode("utf-8") + b"\x00"
    out = np.zeros((len(tokens), PHOC_DIM), np.float32)
    failures = library().phoc_build_batch(
        bytes(packed), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(tokens), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        raise RuntimeError(f"phoc_build_batch failed on {failures} of "
                           f"{len(tokens)} tokens")
    return out
