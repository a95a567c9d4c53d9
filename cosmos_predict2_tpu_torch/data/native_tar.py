"""Native tar-shard reader with background prefetch (ctypes binding).

The port's counterpart of cosmos_predict2_tpu/data/native_tar.py. The C++
side (``cosmos_predict2_tpu_torch/csrc/host/tar_reader.cpp``, the port's
copy of the JAX package's source, built at first use into
``build/cosmos_torch_host/`` by utils/native.py::build_host_library) parses
tar headers, does the file IO and buffers samples in pthreads; Python sees
named byte buffers. Falls back to the stdlib ``tarfile`` where no toolchain
is available, so :class:`NativeTarShard` is always safe to use.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional

import numpy as np

from cosmos_predict2_tpu_torch.utils.native import build_host_library

log = logging.getLogger("cosmos_predict2_tpu_torch")

TAR_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The tar-reader library, built at first use; None when it cannot be
    built or loaded (``tarfile`` is used then)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_host_library("tar_reader.cpp", TAR_FLAGS)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning(f"native tar_reader load failed ({e}); using the tarfile fallback")
            return None
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        vp = ctypes.c_void_p
        for name, args, res in (
            ("tar_index_open", [ctypes.c_char_p], vp),
            ("tar_index_count", [vp], i64),
            ("tar_index_name", [vp, i64], ctypes.c_char_p),
            ("tar_index_size", [vp, i64], i64),
            ("tar_read", [vp, i64, u8p], None),
            ("tar_prefetch_start", [vp, ctypes.POINTER(i64), i64, i64], None),
            ("tar_prefetch_get", [vp, i64, u8p], None),
            ("tar_prefetch_stop", [vp], None),
            ("tar_index_close", [vp], None),
        ):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = res
        _lib = lib
        return _lib


class NativeTarShard:
    """Random access and threaded prefetch over one tar shard."""

    def __init__(self, path: str, prefetch_threads: int = 2):
        self.path = path
        self.prefetch_threads = prefetch_threads
        self._lib = get_lib()
        self._h = None
        self._fallback = None
        self._prefetching: Optional[list[int]] = None
        if self._lib is not None:
            self._h = self._lib.tar_index_open(path.encode())
        if self._h is None:
            import tarfile

            self._fallback = tarfile.open(path)
            self._members = [m for m in self._fallback.getmembers() if m.isreg()]

    @property
    def native(self) -> bool:
        """Whether the C++ reader serves this shard."""
        return self._h is not None

    @property
    def names(self) -> list[str]:
        if self._h is not None:
            n = self._lib.tar_index_count(self._h)
            return [self._lib.tar_index_name(self._h, i).decode() for i in range(n)]
        return [m.name for m in self._members]

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.tar_index_count(self._h))
        return len(self._members)

    def _read_native(self, i: int, fill) -> bytes:
        buf = np.empty(self._lib.tar_index_size(self._h, i), dtype=np.uint8)
        fill(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return buf.tobytes()

    def read(self, i: int) -> bytes:
        if self._h is not None:
            return self._read_native(i, lambda ptr: self._lib.tar_read(self._h, i, ptr))
        return self._fallback.extractfile(self._members[i]).read()

    # ------------------------- async prefetch -------------------------

    def prefetch(self, indices: list[int]) -> None:
        """Begin loading ``indices`` in background threads (off the GIL)."""
        self._prefetching = list(indices)
        if self._h is not None:
            arr = (ctypes.c_int64 * len(indices))(*indices)
            self._lib.tar_prefetch_start(self._h, arr, len(indices), self.prefetch_threads)

    def get_prefetched(self, slot: int) -> bytes:
        """Blocking fetch of the ``slot``-th prefetched sample."""
        if self._prefetching is None:
            raise RuntimeError("call prefetch() first")
        if self._h is None:
            return self.read(self._prefetching[slot])
        return self._read_native(self._prefetching[slot],
                                 lambda ptr: self._lib.tar_prefetch_get(self._h, slot, ptr))

    def end_prefetch(self) -> None:
        if self._h is not None and self._prefetching is not None:
            self._lib.tar_prefetch_stop(self._h)
        self._prefetching = None

    def close(self) -> None:
        if self._h is not None:
            self._lib.tar_index_close(self._h)
            self._h = None
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None
