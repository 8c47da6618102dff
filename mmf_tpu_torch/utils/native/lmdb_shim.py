"""lmdb-package-compatible surface over the native C++ LMDB core
(``src/lmdb_core.cc``).

Port of ``mmf_tpu/utils/native/lmdb_shim.py``: the subset the feature
readers and the conversion tools use, ``open() -> Environment``,
``begin() -> Transaction`` with ``get``/``cursor``/``stat``, and write
transactions backed by the bulk writer. The port reads and writes LMDB
through this core only (it never imports the ``lmdb`` package); the core
is compiled at first use by ``utils/native/build.py``, which raises where
no C++ compiler works.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "src", "lmdb_core.cc"
)
_LIB: Optional[ctypes.CDLL] = None


def _setup(lib):
    lib.lmdb_open.argtypes = [ctypes.c_char_p]
    lib.lmdb_open.restype = ctypes.c_void_p
    lib.lmdb_close.argtypes = [ctypes.c_void_p]
    lib.lmdb_entries.argtypes = [ctypes.c_void_p]
    lib.lmdb_entries.restype = ctypes.c_longlong
    lib.lmdb_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
    ]
    lib.lmdb_get.restype = ctypes.c_longlong
    lib.lmdb_cursor_open.argtypes = [ctypes.c_void_p]
    lib.lmdb_cursor_open.restype = ctypes.c_void_p
    lib.lmdb_cursor_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.lmdb_cursor_next.restype = ctypes.c_int
    lib.lmdb_cursor_close.argtypes = [ctypes.c_void_p]
    lib.lmdb_writer_open.argtypes = [ctypes.c_char_p]
    lib.lmdb_writer_open.restype = ctypes.c_void_p
    lib.lmdb_writer_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.lmdb_writer_put.restype = ctypes.c_int
    lib.lmdb_writer_commit.argtypes = [ctypes.c_void_p]
    lib.lmdb_writer_commit.restype = ctypes.c_int
    lib.lmdb_writer_abort.argtypes = [ctypes.c_void_p]


def library() -> ctypes.CDLL:
    """The core, built at first use; raises when it cannot be built."""
    global _LIB
    if _LIB is None:
        from mmf_tpu_torch.utils.native.build import compile_lib

        _LIB = compile_lib(_SRC, "lmdbcore", _setup, cxx=True)
    return _LIB


class _Cursor:
    def __init__(self, lib, handle):
        self._lib = lib
        self._cur = lib.lmdb_cursor_open(handle)

    def iternext(self, keys=True, values=True):
        kp = ctypes.POINTER(ctypes.c_ubyte)()
        kl = ctypes.c_size_t()
        vp = ctypes.POINTER(ctypes.c_ubyte)()
        vl = ctypes.c_size_t()
        while self._lib.lmdb_cursor_next(
            self._cur, ctypes.byref(kp), ctypes.byref(kl),
            ctypes.byref(vp), ctypes.byref(vl),
        ):
            key = bytes(ctypes.string_at(kp, kl.value)) if keys else None
            val = bytes(ctypes.string_at(vp, vl.value)) if values else None
            if keys and values:
                yield key, val
            elif keys:
                yield key
            else:
                yield val

    def __iter__(self):
        return self.iternext()

    def close(self):
        if self._cur:
            self._lib.lmdb_cursor_close(self._cur)
            self._cur = None


class _Transaction:
    def __init__(self, env, write=False, buffers=False):
        self._env = env
        self._write = write
        self._buffers = buffers
        self._writer = None
        if write:
            lib = env._lib
            self._writer = lib.lmdb_writer_open(env._path.encode())

    def get(self, key, default=None):
        out = ctypes.POINTER(ctypes.c_ubyte)()
        n = self._env._lib.lmdb_get(
            self._env._handle, bytes(key), len(key), ctypes.byref(out)
        )
        if n < 0:
            return default
        return bytes(ctypes.string_at(out, n))

    def put(self, key, value):
        assert self._writer is not None, "read-only transaction"
        rc = self._env._lib.lmdb_writer_put(
            self._writer, bytes(key), len(key), bytes(value), len(value)
        )
        return rc == 0

    def cursor(self):
        return _Cursor(self._env._lib, self._env._handle)

    def commit(self):
        if self._writer is not None:
            rc = self._env._lib.lmdb_writer_commit(self._writer)
            self._writer = None
            if rc != 0:
                raise RuntimeError("lmdb bulk commit failed")
            self._env._reopen()

    def abort(self):
        if self._writer is not None:
            self._env._lib.lmdb_writer_abort(self._writer)
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.commit()
        else:
            self.abort()


class Environment:
    def __init__(self, path, subdir=True, readonly=True, create=False,
                 **kwargs):
        self._lib = library()
        self._path = path
        self._readonly = readonly
        self._handle = None
        if subdir and create:
            os.makedirs(path, exist_ok=True)
        data = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        if os.path.exists(data):
            self._handle = self._lib.lmdb_open(path.encode())
            if not self._handle:
                raise RuntimeError(f"cannot open lmdb at {path}")
        elif readonly:
            raise RuntimeError(f"no lmdb database at {path}")

    def _reopen(self):
        if self._handle:
            self._lib.lmdb_close(self._handle)
        self._handle = self._lib.lmdb_open(self._path.encode())

    def begin(self, write=False, buffers=False):
        if write and self._readonly:
            raise RuntimeError("environment opened read-only")
        return _Transaction(self, write=write, buffers=buffers)

    def stat(self):
        n = self._lib.lmdb_entries(self._handle) if self._handle else 0
        return {"entries": max(0, int(n))}

    def close(self):
        if self._handle:
            self._lib.lmdb_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open(path, subdir=True, readonly=True, create=False, lock=False,
         readahead=False, max_readers=1, map_size=None, **kwargs):
    """lmdb.open-compatible entry point (extra kwargs accepted+ignored)."""
    return Environment(path, subdir=subdir, readonly=readonly, create=create)
