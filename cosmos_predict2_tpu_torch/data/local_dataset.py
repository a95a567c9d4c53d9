"""Local post-training dataset: a folder of video clips and captions.

The port's copy of cosmos_predict2_tpu/data/local_dataset.py, batch for
batch: clips in sorted order, the first ``num_frames`` of a short clip
padded by repeating its last frame and a long clip's window drawn by
``RandomState(seed + idx)``, the aspect-preserving resize and centre crop
of inference/pipeline.py::resize_input, and the precomputed text
embedding trimmed or zero-padded to ``text_len`` (zeros of (text_len,
text_dim) when the clip has none: unconditional training for that clip).

Layout:
    root/
      videos/clip_0001.{mp4,gif,npz,npy,dir}   (any utils/io.py::read_video input)
      metas/clip_0001.txt                      caption
      t5_xxl/clip_0001.npy                     optional precomputed embedding
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from cosmos_predict2_tpu_torch.inference.pipeline import resize_input
from cosmos_predict2_tpu_torch.utils.io import read_video

log = logging.getLogger("cosmos_predict2_tpu_torch")


@dataclasses.dataclass(frozen=True)
class LocalVideoDatasetConfig:
    root: str = "datasets/custom"
    batch_size: int = 1
    num_frames: int = 93  # 4*23+1 <-> state_t 24
    height: int = 704
    width: int = 1280
    text_len: int = 512
    text_dim: int = 1024
    seed: int = 0


class LocalVideoDataset:
    """Endless iterator (and index) of one-clip batches: video uint8 (1, 3,
    T, H, W), fps (1,), padding_mask (1, 1, H, W), caption and
    t5_text_embeddings (1, text_len, dim) fp32."""

    def __init__(self, config: LocalVideoDatasetConfig):
        self.config = config
        vdir = os.path.join(config.root, "videos")
        self.clips = sorted(os.path.join(vdir, f) for f in os.listdir(vdir)) if os.path.isdir(vdir) else []
        if not self.clips:
            raise FileNotFoundError(f"no clips found under {vdir}")
        log.info(f"LocalVideoDataset: {len(self.clips)} clips under {config.root}")

    def __len__(self):
        return len(self.clips)

    def _side_path(self, clip_path: str, folder: str, ext: str) -> str:
        stem = os.path.splitext(os.path.basename(clip_path))[0]
        return os.path.join(self.config.root, folder, stem + ext)

    def __getitem__(self, idx: int) -> dict:
        cfg = self.config
        clip_path = self.clips[idx % len(self.clips)]
        frames, fps = read_video(clip_path)
        if frames.shape[0] < cfg.num_frames:
            pad = np.repeat(frames[-1:], cfg.num_frames - frames.shape[0], axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        else:
            start = np.random.RandomState(cfg.seed + idx).randint(0, frames.shape[0] - cfg.num_frames + 1)
            frames = frames[start : start + cfg.num_frames]
        frames = resize_input(frames, cfg.height, cfg.width)
        batch = {
            "video": frames.transpose(3, 0, 1, 2)[None],  # (1, C, T, H, W) uint8
            "fps": np.asarray([fps], dtype=np.float32),
            "padding_mask": np.zeros((1, 1, cfg.height, cfg.width), dtype=np.float32),
        }
        cap_path = self._side_path(clip_path, "metas", ".txt")
        if os.path.exists(cap_path):
            with open(cap_path) as f:
                batch["caption"] = f.read().strip()
        else:
            batch["caption"] = ""
        emb_path = self._side_path(clip_path, "t5_xxl", ".npy")
        if os.path.exists(emb_path):
            emb = np.load(emb_path).astype(np.float32)
            emb = emb[None] if emb.ndim == 2 else emb
            if emb.shape[1] >= cfg.text_len:
                emb = emb[:, : cfg.text_len]
            else:
                pad = np.zeros((emb.shape[0], cfg.text_len - emb.shape[1], emb.shape[2]), emb.dtype)
                emb = np.concatenate([emb, pad], axis=1)
            batch["t5_text_embeddings"] = emb
        else:
            batch["t5_text_embeddings"] = np.zeros((1, cfg.text_len, cfg.text_dim), dtype=np.float32)
        return batch

    def __iter__(self):
        i = 0
        while True:
            yield self[i]
            i += 1
