"""Build and load the port's CUDA kernels; read and reset their launch counts.

The kernels are CUDA C++ under ``csrc/``, compiled at first use by ``nvcc``
for ``sm_90a`` (one nvcc per source, all started together, then one link)
into one shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
The library lands in ``build/cosmos_torch_kernels/`` at the repository root
(``build/`` is git-ignored) under a name carrying a hash of the sources and
flags, so an edited source triggers a rebuild and an unchanged one loads the
cached library. Importing this module needs no ``nvcc`` and no GPU.

Each kernel's wrapper keeps a plain integer ``launches`` that it raises by
one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "flash_attention_fwd.cu", "flash_attention_bwd.cu", "flash_attention_kv_cache.cu", "conv3d_causal.cu",
    "neighborhood_attention.cu", "flash_attention_jvp.cu",
)
HEADERS = ("mma_bf16.cuh", "sm90_bf16.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cosmos_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # register / shared-memory / spill report, kept in the build log
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcosmos_torch_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    Raises RuntimeError with the compiler's output when nvcc fails. The
    compiler's report (``-Xptxas=-v``) is written beside the library as
    ``build.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{source_hash()}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    cmds = [[nvcc_path(), *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", str(obj)] for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    link = [nvcc_path(), "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    failed = [(cmd, out) for cmd, proc, out in zip(cmds, procs, outputs) if proc.returncode != 0]
    report = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outputs))
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        report += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = [(link, proc.stdout + proc.stderr)]
    (BUILD_DIR / "build.log").write_text(report)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(" ".join(cmd) + "\n" + out for cmd, out in failed))
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.cosmos_flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
            lib.cosmos_flash_attention_fwd.restype = i
            lib.cosmos_flash_attention_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, p]
            lib.cosmos_flash_attention_bwd_dq.restype = i
            lib.cosmos_flash_attention_bwd_dkv.argtypes = [p] * 10 + [i, i, i, i, i, i, f, p]
            lib.cosmos_flash_attention_bwd_dkv.restype = i
            lib.cosmos_flash_attention_bwd_smem_bytes.argtypes = [i]
            lib.cosmos_flash_attention_bwd_smem_bytes.restype = i
            lib.cosmos_flash_attention_jvp.argtypes = [p] * 8 + [i, i, i, i, i, f, p]
            lib.cosmos_flash_attention_jvp.restype = i
            lib.cosmos_flash_attention_fwd_smem_bytes.argtypes = []
            lib.cosmos_flash_attention_fwd_smem_bytes.restype = i
            lib.cosmos_flash_kv_cache.argtypes = [p] * 6 + [i] * 6 + [f, p]
            lib.cosmos_flash_kv_cache.restype = i
            lib.cosmos_flash_kv_cache_window.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, f, p]
            lib.cosmos_flash_kv_cache_window.restype = i
            # x, w_taps, bias, out; T_out, H, W, Cin, Cout, box_w, n, n_split; stream
            lib.cosmos_conv3d_causal.argtypes = [p] * 4 + [i] * 8 + [p]
            lib.cosmos_conv3d_causal.restype = i
            lib.cosmos_conv3d_causal_smem_bytes.argtypes = [i]
            lib.cosmos_conv3d_causal_smem_bytes.restype = i
            # B, heads, S_pad, bt, table or walk width, T, H, W, 3 x window, 3 x stride; scale, stream
            geometry = [i] * 14 + [f, p]
            lib.cosmos_na_fwd.argtypes = [p] * 8 + geometry
            lib.cosmos_na_fwd.restype = i
            lib.cosmos_na_bwd_dq.argtypes = [p] * 10 + geometry
            lib.cosmos_na_bwd_dq.restype = i
            lib.cosmos_na_bwd_dkv.argtypes = [p] * 11 + geometry
            lib.cosmos_na_bwd_dkv.restype = i
            lib.cosmos_na_smem_bytes.argtypes = [i]
            lib.cosmos_na_smem_bytes.restype = i
            _lib = lib
        return _lib


def ptxas_report(log: str | None = None) -> dict[str, dict[str, int]]:
    """Per kernel entry point (mangled name) of the last build, what
    ``-Xptxas=-v`` reported: registers, static shared memory, stack frame
    and spill bytes. Reads ``build.log`` unless given its text."""
    text = (BUILD_DIR / "build.log").read_text() if log is None else log
    report: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        for key, pattern in (("stack_bytes", r"(\d+) bytes stack frame"), ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"), ("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem")):
            found = re.search(pattern, line)
            if found:
                current[key] = int(found.group(1))
    return report


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _wrappers() -> dict:
    from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal
    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
        flash_attention_kv_cache,
        flash_attention_kv_cache_window,
    )
    from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_jvp
    from cosmos_predict2_tpu_torch.ops.neighborhood_attention import na_bwd_dkv, na_bwd_dq, na_fwd

    return {
        "flash_attention_fwd": flash_attention_fwd,
        "flash_attention_bwd_dq": flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
        "flash_attention_kv_cache": flash_attention_kv_cache,
        "flash_attention_kv_cache_window": flash_attention_kv_cache_window,
        "flash_attention_jvp": flash_attention_jvp,
        "conv3d_causal": conv3d_causal,
        "na_fwd": na_fwd,
        "na_bwd_dq": na_bwd_dq,
        "na_bwd_dkv": na_bwd_dkv,
    }


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
