"""Data augmentors for the sharded-tar pipeline (host-side, NumPy).

The port's copy of cosmos_predict2_tpu/data/augmentors.py, after the
reference's augmentor stack (the Augmentor protocol; image resize,
cropping, flip, normalize and padding; VideoParsing,
UniformTemporalSubsample, the text transforms, AppendFPSFramesForImage,
MergeDataDict). They run on the host feed thread and plug into
data/loaders.py::ShardedTarDataset through ``augmentors=[...]``; an
augmentor that returns None drops the sample (the reference's rejection
contract). The per-sample draws are the JAX package's: ``RandomState``
seeded from ``hash(__key__)``.

Layout convention: videos are (T, H, W, C) uint8 or float; images (H, W, C).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from cosmos_predict2_tpu_torch.utils import log


class Augmentor:
    """Protocol match for the reference Augmentor (augmentor.py): maps a
    data dict to a data dict (or None to reject the sample)."""

    def __init__(self, input_keys: Sequence[str], output_keys: Optional[Sequence[str]] = None, args: Optional[dict] = None):
        self.input_keys = list(input_keys)
        self.output_keys = list(output_keys) if output_keys is not None else list(input_keys)
        self.args = args or {}

    def __call__(self, data_dict: dict) -> Optional[dict]:
        raise NotImplementedError


def _resize(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    from cosmos_predict2_tpu_torch.utils.io import resize_frames

    single = frames.ndim == 3
    out = resize_frames(frames[None] if single else frames, height, width)
    return out[0] if single else out


def _hw(x: np.ndarray) -> tuple[int, int]:
    return (x.shape[-3], x.shape[-2])


class ResizeSmallestSide(Augmentor):
    """Resize so the smallest side == args['size'] (image/resize.py)."""

    def __call__(self, d: dict) -> dict:
        size = int(self.args["size"])
        for ik, ok in zip(self.input_keys, self.output_keys):
            h, w = _hw(d[ik])
            scale = size / min(h, w)
            d[ok] = _resize(d[ik], max(1, round(h * scale)), max(1, round(w * scale)))
            if ok != ik:
                del d[ik]
        return d


class ResizeLargestSide(Augmentor):
    def __call__(self, d: dict) -> dict:
        size = int(self.args["size"])
        for ik, ok in zip(self.input_keys, self.output_keys):
            h, w = _hw(d[ik])
            scale = size / max(h, w)
            d[ok] = _resize(d[ik], max(1, round(h * scale)), max(1, round(w * scale)))
            if ok != ik:
                del d[ik]
        return d


class CenterCrop(Augmentor):
    """args: {'height': H, 'width': W} (image/cropping.py)."""

    def __call__(self, d: dict) -> dict:
        ch, cw = int(self.args["height"]), int(self.args["width"])
        for ik, ok in zip(self.input_keys, self.output_keys):
            h, w = _hw(d[ik])
            if h < ch or w < cw:
                # resize up first (reference resizes before crop in recipes)
                scale = max(ch / h, cw / w)
                d[ik] = _resize(d[ik], max(ch, round(h * scale)), max(cw, round(w * scale)))
                h, w = _hw(d[ik])
            y0, x0 = (h - ch) // 2, (w - cw) // 2
            d[ok] = d[ik][..., y0 : y0 + ch, x0 : x0 + cw, :]
            if ok != ik:
                del d[ik]
        return d


class RandomCrop(Augmentor):
    """args: {'height', 'width', 'seed'(opt)} — per-sample rng from __key__."""

    def __call__(self, d: dict) -> dict:
        ch, cw = int(self.args["height"]), int(self.args["width"])
        rng = np.random.RandomState(
            (hash(d.get("__key__", "")) ^ int(self.args.get("seed", 0))) & 0x7FFFFFFF
        )
        for ik, ok in zip(self.input_keys, self.output_keys):
            h, w = _hw(d[ik])
            if h < ch or w < cw:
                return None
            y0 = int(rng.randint(0, h - ch + 1))
            x0 = int(rng.randint(0, w - cw + 1))
            d[ok] = d[ik][..., y0 : y0 + ch, x0 : x0 + cw, :]
            if ok != ik:
                del d[ik]
        return d


class HorizontalFlip(Augmentor):
    """args: {'prob': 0.5, 'seed'(opt)} (image/flip.py)."""

    def __call__(self, d: dict) -> dict:
        rng = np.random.RandomState(
            (hash(d.get("__key__", "")) ^ int(self.args.get("seed", 1)) ^ 0x5F) & 0x7FFFFFFF
        )
        if rng.rand() < float(self.args.get("prob", 0.5)):
            for ik, ok in zip(self.input_keys, self.output_keys):
                d[ok] = d[ik][..., ::-1, :].copy()
        return d


class Normalize(Augmentor):
    """uint8 -> float in [-1, 1] (or custom mean/std) (image/normalize.py)."""

    def __call__(self, d: dict) -> dict:
        mean = float(self.args.get("mean", 127.5))
        std = float(self.args.get("std", 127.5))
        for ik, ok in zip(self.input_keys, self.output_keys):
            d[ok] = (d[ik].astype(np.float32) - mean) / std
            if ok != ik:
                del d[ik]
        return d


class ReflectionPadding(Augmentor):
    """Pad to args {'height','width'} with reflection + emit padding_mask
    (1 where padded) (image/padding.py semantics)."""

    def __call__(self, d: dict) -> dict:
        th, tw = int(self.args["height"]), int(self.args["width"])
        for ik, ok in zip(self.input_keys, self.output_keys):
            x = d[ik]
            h, w = _hw(x)
            ph, pw = max(0, th - h), max(0, tw - w)
            top, left = ph // 2, pw // 2
            pad = [(0, 0)] * (x.ndim - 3) + [(top, ph - top), (left, pw - left), (0, 0)]
            d[ok] = np.pad(x, pad, mode="reflect") if (ph or pw) else x
            mask = np.ones((th, tw), dtype=np.float32)
            mask[top : top + h, left : left + w] = 0.0
            d["padding_mask"] = mask
            if ok != ik:
                del d[ik]
        return d


class UniformTemporalSubsample(Augmentor):
    """Evenly sample args['num_frames'] frames along T
    (pytorchvideo UniformTemporalSubsample used by VideoParsing)."""

    def __call__(self, d: dict) -> Optional[dict]:
        n = int(self.args["num_frames"])
        for ik, ok in zip(self.input_keys, self.output_keys):
            t = d[ik].shape[0]
            if t < 1:
                return None
            idx = np.linspace(0, t - 1, n).round().astype(np.int64)
            d[ok] = d[ik][idx]
            if ok != ik:
                del d[ik]
        return d


class VideoParsing(Augmentor):
    """Decode video bytes + pick a caption window + temporal subsample
    (predict2/datasets/augmentors/video_parsing.py:30-170, simplified to
    the codecs at hand: decode via utils/io.py::read_video).

    input_keys = [meta_key, video_key]; args: num_video_frames, min_fps,
    max_fps, min_duration, key_for_caption. Produces d['video'] (T,H,W,C)
    uint8, d['fps'], d['chunk_index']; returns None to reject.
    """

    def __call__(self, d: dict) -> Optional[dict]:
        meta_key, video_key = self.input_keys
        meta = d.get(meta_key) or {}
        raw = d.get(video_key)
        if raw is None:
            return None
        if isinstance(raw, bytes):
            import tempfile

            from cosmos_predict2_tpu_torch.utils.io import read_video

            with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
                f.write(raw)
                f.flush()
                try:
                    frames, fps = read_video(f.name)
                except Exception as e:
                    log.warning(f"video decode failed for {d.get('__key__')}: {e}")
                    return None
        else:
            frames = np.asarray(raw)
            fps = float(meta.get("framerate", 16))

        if fps < float(self.args.get("min_fps", 1)) or fps > float(self.args.get("max_fps", 120)):
            return None
        windows = meta.get(self.args.get("key_for_caption", "t2w_windows")) or []
        chunk_index = -1
        if windows:
            # prefer non-final 5s windows like the reference; pick the first
            # eligible deterministically per key
            options = windows[:-1] if len(windows) > 1 else windows
            order = np.random.RandomState(hash(d.get("__key__", "")) & 0x7FFFFFFF).permutation(len(options))
            for i in order:
                w = options[int(i)]
                s, e = int(w["start_frame"]), min(int(w["end_frame"]), frames.shape[0])
                if (e - s) >= float(self.args.get("min_duration", 0)) * fps and e > s:
                    frames = frames[s:e]
                    chunk_index = int(i)
                    break
            else:
                return None

        n = int(self.args.get("num_video_frames", 0))
        if n > 0:
            if frames.shape[0] < n:
                return None
            idx = np.linspace(0, frames.shape[0] - 1, n).round().astype(np.int64)
            frames = frames[idx]
        d["video"] = frames
        d["fps"] = fps
        d["chunk_index"] = chunk_index
        return d


class AppendFPSFramesForImage(Augmentor):
    """Image -> pseudo video: repeat the image num_video_frames times and
    stamp a training fps (append_fps_frames_for_image.py)."""

    def __call__(self, d: dict) -> dict:
        (ik,) = self.input_keys
        n = int(self.args.get("num_video_frames", 1))
        img = d[ik]
        d["video"] = np.repeat(img[None], n, axis=0)
        d["fps"] = float(self.args.get("fps", 16))
        return d


class TextTransform(Augmentor):
    """Pick the caption (+ optional precomputed embedding) matching the
    selected video window (text_transforms_for_video.py semantics)."""

    def __call__(self, d: dict) -> Optional[dict]:
        (caption_key,) = self.input_keys
        captions = d.get(caption_key)
        if captions is None:
            return None
        if isinstance(captions, str):
            d["caption"] = captions
            return d
        idx = d.get("chunk_index", 0)
        idx = 0 if idx is None or idx < 0 else idx
        try:
            item = captions[idx]
        except (IndexError, KeyError):
            return None
        d["caption"] = item["caption"] if isinstance(item, dict) else str(item)
        if isinstance(item, dict) and "embedding" in item:
            d["t5_text_embeddings"] = np.asarray(item["embedding"], dtype=np.float32)
        return d


class CaptionFilter(Augmentor):
    """Reject samples with missing/too-short captions (caption_filter.py)."""

    def __call__(self, d: dict) -> Optional[dict]:
        (key,) = self.input_keys
        cap = d.get(key)
        if not cap or len(str(cap).split()) < int(self.args.get("min_words", 1)):
            return None
        return d


class MergeDataDict(Augmentor):
    """Fold a nested dict key's items into the top level (merge_datadict.py)."""

    def __call__(self, d: dict) -> dict:
        for key in self.input_keys:
            sub = d.pop(key, None)
            if isinstance(sub, dict):
                for k, v in sub.items():
                    d.setdefault(k, v)
        return d


def apply_augmentors(sample: Optional[dict], augmentors: Sequence[Augmentor]) -> Optional[dict]:
    """Run the chain; None (rejection) short-circuits."""
    for aug in augmentors:
        if sample is None:
            return None
        sample = aug(sample)
    return sample
