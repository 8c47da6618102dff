"""Native (C and C++) host-side libraries, compiled at first use from
the checkout's sources and loaded through ``ctypes``: the LMDB core
(``lmdb_shim``) and the edit-distance kernels of the ANLS metrics
(``editdist``). ``build.py`` holds the build; it has no fallback."""
