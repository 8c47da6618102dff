"""Build the port's CUDA C++ kernels at first use and load them.

Route: ``nvcc`` compiles the sources under ``ops/csrc/`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Output goes to
``<repo>/build/mmf_tpu_torch/<name>-<hash>/``, keyed by a hash of the
sources, the shared headers (``ops/csrc/*.cuh``) and the flags, so a
checkout builds everything it needs from its own files and a changed
source never loads a stale library. There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "build", "mmf_tpu_torch",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_locks_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _lock_for(name: str) -> threading.Lock:
    """One lock per library, so different libraries build in parallel."""
    with _locks_lock:
        return _locks.setdefault(name, threading.Lock())


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from source at first use"
    )


def load_library(name: str, sources: List[str]) -> Tuple[ctypes.CDLL, dict]:
    """Compile ``sources`` (file names under ``ops/csrc``) once per content
    hash and load the result. Returns ``(library, info)``; ``info`` holds
    ``build_s`` (0.0 when an earlier build was reused), the library path
    and the compiler's ``-Xptxas -v`` report."""
    with _lock_for(name):
        if name in _libs:
            return _libs[name]
        paths = [os.path.join(CSRC, s) for s in sources]
        headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                         if f.endswith(".cuh"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths + headers:
            with open(p, "rb") as f:
                h.update(f.read())
        out_dir = os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")
        lib_path = os.path.join(out_dir, f"lib{name}.so")
        log_path = os.path.join(out_dir, "nvcc.log")
        build_s = 0.0
        if not os.path.exists(lib_path):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_s = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} (rc={proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            with open(log_path, "w") as f:
                f.write(log)
            os.replace(tmp, lib_path)
        with open(log_path) as f:
            log = f.read()
        lib = ctypes.CDLL(lib_path)
        info = {"build_s": build_s, "path": lib_path, "ptxas": log}
        _libs[name] = (lib, info)
        return lib, info
