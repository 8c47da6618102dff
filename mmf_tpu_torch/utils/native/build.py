"""Compile-on-first-use for the port's native host-side libraries (the
LMDB core, the PHOC featurizer, the edit-distance kernels).

Port of ``mmf_tpu/utils/native/build.py``. A library is compiled from
the checkout's own source into
``<repo>/build/mmf_tpu_torch/native/lib<name>-<hash>.so``, keyed by a
hash of the source and the flags, so a changed source never loads a
stale library, and loaded through ``ctypes``. The build writes a
temporary file and renames it into place, so processes that build the
same library at once (test workers, loader workers) each load a whole
file. There is no fallback: where no compiler works, it raises and names
the compilers it tried.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Dict, Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "build", "mmf_tpu_torch", "native",
)

C_COMPILERS = ("cc", "gcc", "clang")
CXX_COMPILERS = ("c++", "g++", "clang++")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def library_path(src: str, lib_name: str,
                 flags: Sequence[str] = ()) -> str:
    """Where ``src`` built with ``flags`` lives."""
    digest = hashlib.sha256()
    with open(src, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR,
                        f"lib{lib_name}-{digest.hexdigest()[:16]}.so")


def compile_lib(src: str, lib_name: str,
                setup: Callable[[ctypes.CDLL], None], cxx: bool = False,
                extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``src`` (once per source hash), load it and run ``setup`` to
    declare its signatures. Raises when no compiler builds it."""
    flags = ["-O2", "-shared", "-fPIC", *extra_flags]
    path = library_path(src, lib_name, flags)
    with _lock:
        if path in _libs:
            return _libs[path]
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            errors = []
            for cc in (CXX_COMPILERS if cxx else C_COMPILERS):
                try:
                    subprocess.run([cc, *flags, "-o", tmp, src], check=True,
                                   capture_output=True, text=True)
                    break
                except FileNotFoundError:
                    errors.append(f"{cc}: not found")
                except subprocess.CalledProcessError as e:
                    errors.append(f"{cc}: {e.stderr.strip()[-400:]}")
            else:
                raise RuntimeError(
                    f"cannot build {os.path.basename(src)}: no "
                    f"{'C++' if cxx else 'C'} compiler works ("
                    + "; ".join(errors) + ")")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        setup(lib)
        _libs[path] = lib
        return lib


def loaded() -> Dict[str, str]:
    """Library file name -> path of every native library loaded so far."""
    with _lock:
        return {os.path.basename(p): p for p in _libs}
