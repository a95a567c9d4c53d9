"""Decoders for the sharded-tar pipeline (host-side, NumPy).

The port's copy of cosmos_predict2_tpu/data/decoders.py, after the
reference's image, pickle and depth decoders and its video decoders: keyed
by file extension, each returns the decoded value or None when the
extension is not its business (so a list of decoders can be probed in
order). The video decoders are factories registered in
:data:`VIDEO_DECODER_OPTIONS` with the reference's frame sampling (the
chunked-caption chunk choice and the stride-preferring lowered-fps
sampler), drawn from a seeded ``np.random.default_rng``. Byte decode uses
imageio (gif and webp natively; mp4 needs an ffmpeg plugin); the sampling
is format-blind and takes a ``read_fn`` for any other reader.

Layout convention (data/augmentors.py): videos (T, H, W, C) uint8, images
(H, W, C) uint8.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Callable, Optional

import numpy as np

IMG_EXTENSIONS = ("jpg", "jpeg", "png", "ppm", "pgm", "pbm", "pnm", "webp")
VIDEO_EXTENSIONS = ("mp4", "avi", "webm", "mov", "gif")


def pil_image_decoder(key: str, data: bytes) -> Optional[np.ndarray]:
    """Image bytes -> (H, W, 3) uint8 RGB; None for non-image extensions.

    Reference: imaginaire/datasets/webdataset/decoders/image.py pil_loader.
    """
    ext = key.rpartition(".")[2].lower()
    if ext not in IMG_EXTENSIONS:
        return None
    from PIL import Image

    with io.BytesIO(data) as stream:
        img = Image.open(stream)
        img.load()
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def pickle_decoder(key: str, data: bytes) -> Optional[Any]:
    """Reference: decoders/pickle.py pkl_decoder."""
    ext = key.rpartition(".")[2].lower()
    if ext not in ("pkl", "pickle"):
        return None
    return pickle.loads(data)


MAX_DEPTH = 100000.0


def depth_decoder(key: str, data: bytes) -> Optional[np.ndarray]:
    """Depth map -> (1, H, W) float32, NaN holes filled with MAX_DEPTH.

    Covers the reference's npz depth path (decoders/depth.py npz_loader);
    the EXR path needs OpenEXR, which is not a dependency — raise a
    clear error instead of mis-decoding.
    """
    ext = key.rpartition(".")[2].lower()
    if ext == "exr":
        raise RuntimeError("EXR depth decode requires OpenEXR, which is not a dependency")
    if ext != "npz":
        return None
    with np.load(io.BytesIO(data)) as z:
        depth = np.asarray(z[z.files[0]], dtype=np.float32)
    depth = np.where(np.isnan(depth), MAX_DEPTH, depth)
    return depth[None] if depth.ndim == 2 else depth


# ----------------------------- video decoders -----------------------------

VIDEO_DECODER_OPTIONS: dict[str, Callable[..., Callable]] = {}


def video_decoder_register(name: str):
    def deco(fn):
        VIDEO_DECODER_OPTIONS[name] = fn
        return fn

    return deco


def get_video_decoder(name: str, **kwargs) -> Callable[[str, bytes], Optional[dict]]:
    return VIDEO_DECODER_OPTIONS[name](**kwargs)


def _read_video_bytes(ext: str, data: bytes) -> tuple[np.ndarray, float]:
    """bytes -> ((T, H, W, C) uint8, fps). imageio-based; mp4 needs the
    ffmpeg plugin (see the module docstring)."""
    import imageio.v3 as iio

    frames = iio.imread(data, extension=f".{ext}", index=None)
    if frames.ndim == 3:
        frames = frames[None]
    if frames.shape[-1] == 4:
        frames = frames[..., :3]
    meta = iio.immeta(data, extension=f".{ext}")
    fps = float(meta.get("fps") or (1000.0 / meta["duration"] if meta.get("duration") else 0.0))
    return np.ascontiguousarray(frames[..., :3]), fps


def sample_chunk_index(
    n_video_frames: int, n_target_frames: int, chunk_size: int, rng: np.random.Generator
) -> tuple[int, int]:
    """Chunked-caption chunk selection (reference video_decoder.py
    sample_chunk_index_from_chunked_video): one caption per ``chunk_size``
    frames; a tail of >= chunk_size/2 frames counts as its own chunk.
    Returns (chunk_index, frames_in_chunk); raises if the chunk is too
    short for the request.
    """
    n_chunks = max(n_video_frames // chunk_size, 1)
    tail = n_video_frames - n_chunks * chunk_size
    if tail >= chunk_size // 2 and tail > n_target_frames:
        n_chunks += 1
    idx = int(rng.integers(0, n_chunks))
    frames_in_chunk = n_video_frames - idx * chunk_size if idx == n_chunks - 1 else chunk_size
    if n_target_frames > frames_in_chunk:
        raise ValueError(
            f"sequence_length {n_target_frames} exceeds chunk of {frames_in_chunk} frames "
            f"(video {n_video_frames} frames, chunk_size {chunk_size}, chunk {idx})"
        )
    return idx, frames_in_chunk


def lowered_fps_indices(
    n_video_frames: int,
    video_fps: float,
    min_fps: float,
    max_fps: float,
    n_target_frames: int,
    rng: np.random.Generator,
) -> tuple[list[int], float]:
    """Stride-preferring fps-lowering sampler (reference
    get_frame_indices_w_lowered_fps): enumerate strides whose resulting
    fps lands in [min_fps, max_fps], pick among the two largest with
    weights [0.01, 0.99], random start. Returns (indices, new_fps)."""
    max_stride = (n_video_frames - 1) // (n_target_frames - 1)
    valid = [
        s
        for s in range(1, max_stride + 1)
        if n_video_frames - s * (n_target_frames - 1) > 0 and min_fps <= video_fps / s <= max_fps
    ]
    if not valid:
        raise ValueError(
            f"no valid stride: frames={n_video_frames} fps={video_fps} "
            f"target={n_target_frames} fps_range=[{min_fps},{max_fps}]"
        )
    if len(valid) >= 2:
        stride = int(rng.choice(valid[-2:], p=[0.01, 0.99]))
    else:
        stride = valid[0]
    max_start = n_video_frames - (n_target_frames - 1) * stride
    start = int(rng.integers(0, max_start))
    return [start + i * stride for i in range(n_target_frames)], video_fps / stride


def _check_video(n_video_frames: int, n_target_frames: int, video_fps: float) -> None:
    """Basic sanity (reference basic_check_on_inputs); the fps-range check
    is per-variant: direct for the plain decoder, via stride enumeration
    for the lowered-fps one."""
    if n_video_frames <= 0:
        raise ValueError("empty video")
    if video_fps < 1:
        raise ValueError(f"video fps {video_fps} lower than 1, skipping")
    if n_target_frames <= 1:
        raise ValueError("sequence_length must be > 1")
    if n_target_frames > n_video_frames:
        raise ValueError(f"sequence_length {n_target_frames} exceeds video frames {n_video_frames}")


@video_decoder_register("video_naive_bytes")
def video_naive_bytes(**_):
    """Pass the raw container bytes through (decode later in the pipe)."""

    def decoder(key: str, data: bytes) -> Optional[bytes]:
        ext = key.rpartition(".")[2].lower()
        return data if ext in VIDEO_EXTENSIONS else None

    return decoder


def _chunked_decoder_impl(
    chunk_size: int,
    sequence_length: int,
    min_fps: float,
    max_fps: float,
    lower_fps: bool,
    seed: Optional[int],
    read_fn: Optional[Callable[[str, bytes], tuple[np.ndarray, float]]],
):
    rng = np.random.default_rng(seed)
    read = read_fn or (lambda ext, data: _read_video_bytes(ext, data))

    def decoder(key: str, data: bytes) -> Optional[dict]:
        ext = key.rpartition(".")[2].lower()
        if ext not in VIDEO_EXTENSIONS:
            return None
        frames, fps = read(ext, data)
        n = len(frames)
        n_target = sequence_length if sequence_length > 0 else n
        fps = float(np.round(fps))
        _check_video(n, n_target, fps)
        cur_chunk = n if chunk_size == 0 else chunk_size
        chunk_idx, frames_in_chunk = sample_chunk_index(n, n_target, cur_chunk, rng)
        chunk_start = chunk_idx * cur_chunk
        if lower_fps:
            rel, new_fps = lowered_fps_indices(frames_in_chunk, fps, min_fps, max_fps, n_target, rng)
            idx = [chunk_start + r for r in rel]
        else:
            if not (min_fps <= fps <= max_fps):
                raise ValueError(f"video fps {fps} outside [{min_fps}, {max_fps}], skipping")
            start = chunk_start + int(rng.integers(0, frames_in_chunk - n_target + 1))
            idx, new_fps = list(range(start, start + n_target)), fps
        video = frames[np.asarray(idx)]
        return {
            "video": video,  # (T, H, W, C) uint8 — repo layout convention
            "fps": float(new_fps),
            "orig_fps": float(fps),
            "num_frames": int(video.shape[0]),
            "chunk_index": int(chunk_idx),
            "frame_start": int(idx[0]),
            "frame_end": int(idx[-1] + 1),
            "n_orig_video_frames": int(n),
        }

    return decoder


@video_decoder_register("chunked_video_decoder")
def chunked_video_decoder(
    chunk_size: int = 0,
    sequence_length: int = 34,
    min_fps_thres: float = 1,
    max_fps_thres: float = 9999,
    seed: Optional[int] = None,
    read_fn=None,
    **_,
):
    """Chunk-sampled contiguous frames (reference chunked_video_decoder)."""
    return _chunked_decoder_impl(
        chunk_size, sequence_length, min_fps_thres, max_fps_thres, lower_fps=False, seed=seed, read_fn=read_fn
    )


@video_decoder_register("chunked_video_decoder_w_lower_fps")
def chunked_video_decoder_w_lower_fps(
    chunk_size: int = 0,
    sequence_length: int = 34,
    min_fps_thres: float = 4,
    max_fps_thres: float = 30,
    seed: Optional[int] = None,
    read_fn=None,
    **_,
):
    """Chunk-sampled frames with >=99%-probability fps lowering
    (reference chunked_video_decoder_w_lower_fps)."""
    return _chunked_decoder_impl(
        chunk_size, sequence_length, min_fps_thres, max_fps_thres, lower_fps=True, seed=seed, read_fn=read_fn
    )
