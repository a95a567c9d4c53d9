"""Unified file IO: load / dump dispatched by extension across backends.

The port's counterpart of cosmos_predict2_tpu/utils/easy_io.py, after the
reference's easy_io (cosmos_predict2/_src/imaginaire/utils/easy_io/:
backends x handlers). ``load(path)`` / ``dump(obj, path)`` pick a handler
from the extension (json / yaml / txt / npy / npz / pt|pth / safetensors /
png|jpg / gif / mp4 / csv / msgpack / jsonl / pkl / gz / tar / bytes) and a
backend from the scheme: a local file, http(s) read-only, and the s3:// /
gs:// / msc:// clients of utils/remote_io.py. Custom backends (an object
with get / put / exists, or a plain reader callable) register through
``register_backend``; an S3 store with the deployment's credentials is
``register_backend("s3", S3Backend(**CredentialEnvParser().backend_args(role)))``.

``.pt`` / ``.pth`` go through ``torch.load(weights_only=True)`` and
``torch.save``. ``.msgpack`` is the layout Flax's ``serialization`` module writes
(ndarrays as its ext type 1, NumPy scalars as type 3, complex as type 2,
arrays over 1 GiB chunked), through the ``msgpack`` package, so a file the
JAX package dumped loads here to the same arrays and the reverse. The
packages a format needs beyond the standard library, NumPy and torch
(PyYAML, msgpack, safetensors, PIL, imageio, ml_dtypes for bfloat16 arrays)
are imported in the branch that needs them; a missing one raises an
ImportError that names the format.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any

import numpy as np

_BACKENDS: dict[str, Any] = {}


def register_backend(scheme: str, backend: Any) -> None:
    """Register a backend: either an object with get(path)->bytes (and
    optionally put(bytes, path) / exists(path) / list(prefix)), or a bare
    reader callable (read-only)."""
    _BACKENDS[scheme] = backend


def get_backend(scheme: str):
    """Backend for a scheme; s3 / gs / msc are built at first use from the
    environment (AWS_* and COSMOS_S3_CREDENTIAL_PATH; GOOGLE_OAUTH_ACCESS_TOKEN
    and STORAGE_EMULATOR_HOST; MSC_CONFIG and MSC_PROFILE)."""
    if scheme not in _BACKENDS:
        from cosmos_predict2_tpu_torch.utils import remote_io

        if scheme == "s3":
            _BACKENDS[scheme] = remote_io.S3Backend(credential_path=os.environ.get("COSMOS_S3_CREDENTIAL_PATH"))
        elif scheme == "gs":
            _BACKENDS[scheme] = remote_io.GCSBackend()
        elif scheme == "msc":
            _BACKENDS[scheme] = remote_io.MSCBackend(config_path=os.environ.get("MSC_CONFIG"),
                                                     profile=os.environ.get("MSC_PROFILE", "default"))
        else:
            raise NotImplementedError(f"no backend registered for scheme '{scheme}://'")
    return _BACKENDS[scheme]


def _scheme(path: str) -> str:
    return path.split("://", 1)[0] if "://" in path else ""


def _require(module: str, fmt: str):
    """Import ``module`` for the format ``fmt``, or raise an ImportError
    that names both."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"easy_io: {fmt} files need the '{module.split('.')[0]}' package, which is not "
                          "installed") from e


def _read_bytes(path: str) -> bytes:
    if path.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(path) as r:
            return r.read()
    scheme = _scheme(path)
    if scheme:
        backend = get_backend(scheme)
        return backend.get(path) if hasattr(backend, "get") else backend(path)
    with open(path, "rb") as f:
        return f.read()


def _write_bytes(data: bytes, path: str) -> None:
    scheme = _scheme(path)
    if scheme:
        backend = get_backend(scheme)
        if not hasattr(backend, "put"):
            raise NotImplementedError(f"backend for '{scheme}://' is read-only")
        backend.put(data, path)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower().lstrip(".")


# ----------------------- msgpack, Flax's serialization layout -----------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_MAX_CHUNK_BYTES = 2**30  # Flax's serialization.MAX_CHUNK_SIZE


def _np_dtype(name: str):
    if name == "bfloat16":
        return _require("ml_dtypes", "bfloat16 arrays in .msgpack").bfloat16
    return np.dtype(name)


def _ndarray_to_bytes(msgpack, arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=_np_dtype(dtype_name.decode()), count=-1, offset=0).reshape(shape, order="C")


def _to_numpy(x):
    """torch tensors become arrays (bf16 through ml_dtypes); the rest is kept."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_np_dtype("bfloat16"))
        return x.numpy()
    return x


def _chunk_leaves(tree):
    """Arrays over 1 GiB -> Flax's chunked dict, in a copy of the dicts."""
    tree = _to_numpy(tree)
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > _MAX_CHUNK_BYTES:
        per = max(1, int(_MAX_CHUNK_BYTES / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        chunks = [flat[i : i + per] for i in range(0, flat.size, per)]
        return {"__msgpack_chunked_array__": True, "shape": {str(i): n for i, n in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            return np.concatenate([tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_serialize(tree) -> bytes:
    """Flax's ``serialization.msgpack_serialize`` bytes for a tree of dicts,
    lists and array (or tensor) leaves."""
    msgpack = _require("msgpack", ".msgpack")

    def pack_ext(x):
        x = _to_numpy(x)
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(msgpack, x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(msgpack, np.asarray(x)))
        if isinstance(x, complex):
            return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
        return x

    return msgpack.packb(_chunk_leaves(tree), default=pack_ext, strict_types=True)


def msgpack_restore(data: bytes):
    """Flax's ``serialization.msgpack_restore``: arrays as NumPy arrays."""
    msgpack = _require("msgpack", ".msgpack")

    def unpack_ext(code, payload):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, payload)
        if code == _EXT_COMPLEX:
            real, imag = msgpack.unpackb(payload)
            return complex(real, imag)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, payload)[()]
        return msgpack.ExtType(code, payload)

    return _unchunk_leaves(msgpack.unpackb(data, ext_hook=unpack_ext, raw=False))


# ------------------------------- load / dump -------------------------------


def load(path: str, **kwargs) -> Any:
    ext = _ext(path)
    if ext == "json":
        return json.loads(_read_bytes(path))
    if ext in ("yaml", "yml"):
        return _require("yaml", ".yaml").safe_load(_read_bytes(path))
    if ext == "txt":
        return _read_bytes(path).decode("utf-8")
    if ext == "npy":
        return np.load(io.BytesIO(_read_bytes(path)), allow_pickle=False)
    if ext == "npz":
        return dict(np.load(io.BytesIO(_read_bytes(path)), allow_pickle=False))
    if ext in ("pt", "pth"):
        import torch

        return torch.load(io.BytesIO(_read_bytes(path)), map_location="cpu", weights_only=True)
    if ext == "safetensors":
        return _require("safetensors.torch", ".safetensors").load(_read_bytes(path))
    if ext in ("png", "jpg", "jpeg", "webp"):
        _require("PIL", f".{ext}")
        from cosmos_predict2_tpu_torch.utils.io import read_image

        return read_image(path)
    if ext in ("mp4", "gif", "webm", "mkv"):
        _require("PIL" if ext == "gif" else "imageio", f".{ext}")
        from cosmos_predict2_tpu_torch.utils.io import read_video

        return read_video(path, **kwargs)
    if ext == "csv":
        import csv

        return list(csv.reader(_read_bytes(path).decode("utf-8").splitlines()))
    if ext == "msgpack":
        return msgpack_restore(_read_bytes(path))
    if ext == "jsonl":
        return [json.loads(line) for line in _read_bytes(path).decode("utf-8").splitlines() if line.strip()]
    if ext in ("pkl", "pickle"):
        # Unpickling executes arbitrary code; remote (s3/gs/http) paths are
        # attacker-influenceable, so require an explicit opt-in there.
        # Prefer msgpack/npz for remote artifacts.
        if _scheme(path) and not kwargs.get("allow_pickle", False):
            raise ValueError(
                f"refusing to unpickle remote path {path!r}: pickle can execute "
                "arbitrary code. Pass allow_pickle=True if the source is trusted, "
                "or use .msgpack/.npz instead."
            )
        import pickle

        return pickle.loads(_read_bytes(path))
    if ext == "gz":
        # gzipped inner handler, e.g. .json.gz / .jsonl.gz / .txt.gz
        import gzip
        import tempfile

        inner = os.path.basename(path)[: -len(".gz")]
        data = gzip.decompress(_read_bytes(path))
        with tempfile.TemporaryDirectory() as td:
            local = os.path.join(td, inner)
            with open(local, "wb") as f:
                f.write(data)
            return load(local, **kwargs)
    if ext == "tar":
        import tarfile

        return tarfile.open(fileobj=io.BytesIO(_read_bytes(path)), mode="r")
    if ext in ("bin", "bytes"):
        return _read_bytes(path)
    raise NotImplementedError(f"no load handler for extension .{ext}")


def dump(obj: Any, path: str, **kwargs) -> str:
    scheme = _scheme(path)
    if scheme and not path.startswith(("http://", "https://")):
        # remote: serialize through a local temp file (reuses every
        # extension handler), then upload via the backend.
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            local = os.path.join(td, os.path.basename(path))
            written = dump(obj, local, **kwargs)
            with open(written, "rb") as f:
                data = f.read()
        # media handlers may change the extension (mp4 -> gif fallback)
        if os.path.basename(written) != os.path.basename(path):
            path = path.rsplit("/", 1)[0] + "/" + os.path.basename(written)
        _write_bytes(data, path)
        return path
    ext = _ext(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if ext == "json":
        with open(path, "w") as f:
            json.dump(obj, f, indent=kwargs.get("indent", 2), default=str)
    elif ext in ("yaml", "yml"):
        yaml = _require("yaml", ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump(obj, f, sort_keys=False)
    elif ext == "txt":
        with open(path, "w") as f:
            f.write(obj)
    elif ext == "npy":
        np.save(path, obj)
    elif ext == "npz":
        np.savez(path, **obj)
    elif ext in ("pt", "pth"):
        import torch

        torch.save(obj, path)
    elif ext in ("png", "jpg", "jpeg", "mp4", "gif"):
        _require("PIL" if ext != "mp4" else "imageio", f".{ext}")
        from cosmos_predict2_tpu_torch.utils.io import save_img_or_video

        arr = np.asarray(obj)
        if arr.ndim == 3:
            arr = arr[None]
        return save_img_or_video(arr, path, fps=kwargs.get("fps", 16))
    elif ext == "csv":
        import csv

        with open(path, "w", newline="") as f:
            csv.writer(f).writerows(obj)
    elif ext == "msgpack":
        data = msgpack_serialize(obj)
        with open(path, "wb") as f:
            f.write(data)
    elif ext == "jsonl":
        with open(path, "w") as f:
            for row in obj:
                f.write(json.dumps(row, default=str) + "\n")
    elif ext in ("pkl", "pickle"):
        import pickle

        with open(path, "wb") as f:
            pickle.dump(obj, f)
    elif ext == "gz":
        import gzip
        import tempfile

        inner = os.path.basename(path)[: -len(".gz")]
        with tempfile.TemporaryDirectory() as td:
            local = os.path.join(td, inner)
            written = dump(obj, local, **kwargs)
            with open(written, "rb") as f:
                data = f.read()
        with open(path, "wb") as f:
            f.write(gzip.compress(data))
    elif ext in ("bin", "bytes"):
        with open(path, "wb") as f:
            f.write(obj)
    else:
        raise NotImplementedError(f"no dump handler for extension .{ext}")
    return path


def exists(path: str) -> bool:
    if "://" in path and not path.startswith(("http://", "https://")):
        backend = get_backend(_scheme(path))
        if hasattr(backend, "exists"):
            return backend.exists(path)
        raise NotImplementedError(f"exists() not supported by the '{_scheme(path)}://' backend")
    if path.startswith(("http://", "https://")):
        import urllib.request

        try:
            req = urllib.request.Request(path, method="HEAD")
            urllib.request.urlopen(req)
            return True
        except Exception:
            return False
    return os.path.exists(path)
