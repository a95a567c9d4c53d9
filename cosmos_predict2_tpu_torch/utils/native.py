"""Native (C++) host-side media ops, loaded with ctypes.

The port's counterpart of cosmos_predict2_tpu/utils/native.py: the data
pipeline's hot loops (frame resize, crop, normalize) in
``cosmos_predict2_tpu_torch/csrc/host/media_ops.cpp``, the port's own copy
of the JAX package's source. :func:`build_host_library` compiles a host
source with g++ at first use into ``build/cosmos_torch_host/`` (git-ignored)
under a name that carries a hash of the source and flags; every entry point
keeps the JAX package's NumPy fallback for a host without a toolchain.
``route_counts`` counts the calls that took each route ("native" or
"numpy"), so a run can show which one it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from cosmos_predict2_tpu_torch.utils import log

HOST_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
HOST_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "cosmos_torch_host"
MEDIA_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")

route_counts = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_host_library(source: str, flags: tuple[str, ...]) -> Optional[Path]:
    """Compile ``csrc/host/<source>`` with g++ unless the library for this
    source and these flags exists; None (with a warning) when g++ is absent
    or fails."""
    src = HOST_SRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = HOST_BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *flags, "-o", str(tmp), str(src)], check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.warning(f"native {source} build failed ({e}); using the fallback")
        return None
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The media library, built at first use; None when it cannot be built
    or loaded (the NumPy fallbacks run then)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_host_library("media_ops.cpp", MEDIA_FLAGS)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning(f"native media_ops load failed ({e}); using the NumPy fallbacks")
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        for name in ("resize_bilinear_u8", "resize_nearest_u8", "center_crop_u8"):
            getattr(lib, name).argtypes = [u8p, i64, i64, i64, u8p, i64, i64]
            getattr(lib, name).restype = None
        lib.u8_to_pm1_f32.argtypes = [u8p, i64, f32p]
        lib.u8_to_pm1_f32.restype = None
        _lib = lib
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _route(lib) -> Optional[ctypes.CDLL]:
    route_counts["native" if lib is not None else "numpy"] += 1
    return lib


def resize_bilinear(frames: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, oh, ow, 3) uint8, half-pixel bilinear."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, _ = frames.shape
    out = np.empty((t, oh, ow, 3), dtype=np.uint8)
    lib = _route(get_lib())
    if lib is not None:
        lib.resize_bilinear_u8(_u8ptr(frames), t, h, w, _u8ptr(out), oh, ow)
        return out
    fy = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
    fx = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
    y0 = fy.astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    wy = (fy - y0)[None, :, None, None]
    x0 = fx.astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    wx = (fx - x0)[None, None, :, None]
    f = frames.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy + 0.5).astype(np.uint8)


def center_crop(frames: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """(T, H, W, 3) uint8 -> its centred (T, ch, cw, 3) window."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, _ = frames.shape
    lib = _route(get_lib())
    if lib is not None:
        out = np.empty((t, ch, cw, 3), dtype=np.uint8)
        lib.center_crop_u8(_u8ptr(frames), t, h, w, _u8ptr(out), ch, cw)
        return out
    top, left = (h - ch) // 2, (w - cw) // 2
    return frames[:, top : top + ch, left : left + cw].copy()


def to_pm1_float(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]."""
    frames_u8 = np.ascontiguousarray(frames_u8, dtype=np.uint8)
    lib = _route(get_lib())
    if lib is not None:
        out = np.empty(frames_u8.shape, dtype=np.float32)
        lib.u8_to_pm1_f32(_u8ptr(frames_u8), frames_u8.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    return frames_u8.astype(np.float32) / 127.5 - 1.0
