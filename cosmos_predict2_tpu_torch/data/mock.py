"""Mock data: deterministic random batches in the training batch schema.

The port's copy of cosmos_predict2_tpu/data/mock.py (NumPy only): video
uint8 (B, 3, T, H, W), ``t5_text_embeddings`` (B, text_len, text_dim) fp32,
fps and padding_mask, the same values for the same (seed, iteration).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MockDataConfig:
    batch_size: int = 1
    num_frames: int = 9
    height: int = 64
    width: int = 64
    text_len: int = 512
    text_dim: int = 1024
    fps: float = 16.0
    seed: int = 0
    is_image: bool = False


class MockDataLoader:
    """Infinite iterator of deterministic random batches (NumPy, host-side)."""

    def __init__(self, config: MockDataConfig = MockDataConfig()):
        self.config = config

    def __iter__(self):
        i = 0
        while True:
            yield self.get_batch(i)
            i += 1

    def get_batch(self, iteration: int) -> dict:
        cfg = self.config
        rng = np.random.RandomState((cfg.seed * 1_000_003 + iteration) % (2**31))
        t = 1 if cfg.is_image else cfg.num_frames
        video = rng.randint(0, 256, size=(cfg.batch_size, 3, t, cfg.height, cfg.width), dtype=np.uint8)
        batch = {
            "video": video,
            "t5_text_embeddings": rng.randn(cfg.batch_size, cfg.text_len, cfg.text_dim).astype(np.float32),
            "fps": np.full((cfg.batch_size,), cfg.fps, dtype=np.float32),
            "padding_mask": np.zeros((cfg.batch_size, 1, cfg.height, cfg.width), dtype=np.float32),
        }
        if cfg.is_image:
            batch["images"] = batch.pop("video")[:, :, 0]
        return batch


def normalize_video(video_uint8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float [-1, 1]."""
    return video_uint8.astype(np.float32) / 127.5 - 1.0
