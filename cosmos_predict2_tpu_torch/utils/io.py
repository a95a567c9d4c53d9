"""Media IO for the port: image and video read, resolution buckets, export.

The port's own copy of what it uses of cosmos_predict2_tpu/utils/io.py
(``read_image``, ``read_video``, ``get_resolution``, ``save_img_or_video``),
NumPy, PIL and imageio only. Host-side: device code never touches files.
"""

from __future__ import annotations

import os

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Read an image -> uint8 (H, W, 3)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def read_video(path: str) -> tuple[np.ndarray, float]:
    """Read a video -> (uint8 (T, H, W, 3), fps).

    Supports mp4/webm/mkv (when an imageio video backend is present), gif,
    .npy/.npz frame stacks and directories of numbered pngs.
    """
    if os.path.isdir(path):
        from PIL import Image

        files = sorted(os.listdir(path))
        frames = np.stack([np.asarray(Image.open(os.path.join(path, f)).convert("RGB")) for f in files])
        return frames.astype(np.uint8), 16.0
    if path.endswith(".npy"):
        return np.load(path).astype(np.uint8), 16.0
    if path.endswith(".npz"):
        data = np.load(path)
        return data["video"].astype(np.uint8), float(data.get("fps", 16.0))
    if path.endswith(".gif"):
        from PIL import Image, ImageSequence

        img = Image.open(path)
        frames = np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(img)])
        return frames.astype(np.uint8), 1000.0 / img.info.get("duration", 62.5)

    import imageio.v3 as iio

    frames = np.asarray(iio.imread(path))
    try:
        meta = iio.immeta(path)
    except Exception:  # container without readable metadata: default fps
        meta = {}
    fps = float(meta.get("fps", 16.0))
    if frames.ndim == 3:
        frames = frames[None]
    return frames.astype(np.uint8), fps


def save_img_or_video(frames_f32: np.ndarray, path: str, fps: int = 16) -> str:
    """Save frames (T, H, W, 3) -> mp4 (gif where no video codec is
    installed), or png if T == 1.

    Float frames are in [-1, 1], as every pipeline path produces them; uint8
    frames are written as they are.
    """
    frames = np.asarray(frames_f32)
    if frames.dtype != np.uint8:
        frames = (np.clip((frames + 1.0) / 2.0, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if frames.shape[0] == 1 or path.endswith(".png") or path.endswith(".jpg"):
        from PIL import Image

        if not path.endswith((".png", ".jpg")):
            path = path + ".png"
        Image.fromarray(frames[0]).save(path)
        return path
    if not path.endswith((".mp4", ".gif")):
        path = path + ".mp4"
    if path.endswith(".mp4"):
        try:
            import imageio.v3 as iio

            iio.imwrite(path, frames, fps=fps)
            return path
        except Exception:  # no video codec in this environment: write a gif
            path = path[:-4] + ".gif"
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return path


# Resolution buckets (reference predict2/datasets/utils.py:44-59).
VIDEO_RES_SIZE_INFO: dict[str, dict[str, tuple[int, int]]] = {
    "480": {"16,9": (832, 480), "9,16": (480, 832), "1,1": (640, 640), "4,3": (768, 576), "3,4": (576, 768)},
    "720": {"16,9": (1280, 704), "9,16": (704, 1280), "1,1": (960, 960), "4,3": (1088, 832), "3,4": (832, 1088)},
    "720p": {"16,9": (1280, 720), "9,16": (720, 1280), "1,1": (960, 960), "4,3": (1088, 832), "3,4": (832, 1088)},
}


def get_resolution(resolution: str, aspect: str = "16,9") -> tuple[int, int]:
    """Returns (width, height) for a resolution bucket."""
    return VIDEO_RES_SIZE_INFO[resolution][aspect]
