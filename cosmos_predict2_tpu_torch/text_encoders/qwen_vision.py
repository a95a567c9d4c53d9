"""The Qwen2.5-VL vision tower in PyTorch (video and image prompts for
Cosmos-Reason1).

Counterpart of cosmos_predict2_tpu/text_encoders/qwen_vision.py: a patch
embedding over (2, 14, 14) patches, 2-D rotary embeddings over the
merge-ordered (h, w) grid, window attention (112-pixel windows) with full
attention on ``fullatt_block_indexes`` (7, 15, 23, 31), RMSNorm + SwiGLU
blocks (biased qkv, proj and MLP), and the 2x2 patch merger projecting to
the LM's width. Submodules carry HF's names (``patch_embed.proj``,
``blocks.{i}.norm{1,2}``, ``blocks.{i}.attn.{qkv,proj}``,
``blocks.{i}.mlp.{gate,up,down}_proj``, ``merger.ln_q``,
``merger.mlp.{0,2}``).

``grid_thw`` is host metadata: :func:`rot_pos_emb` and
:func:`get_window_index` compute the rotary angles, the window permutation
and each attention segment in NumPy, and :func:`encode_pixels` hands the
tower index tensors. Attention is masked by segment (block-diagonal over
windows, or over images on the full-attention blocks), plain PyTorch: heads
of 80 and at most a few thousand patches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from cosmos_predict2_tpu_torch.networks.dit import RMSNorm
from cosmos_predict2_tpu_torch.text_encoders.common import attention, build_tower, dense, gelu, silu


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    hidden_size: int = 1280
    out_hidden_size: int = 3584
    intermediate_size: int = 3420
    depth: int = 32
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @classmethod
    def tiny(cls) -> "QwenVisionConfig":
        return cls(hidden_size=64, out_hidden_size=48, intermediate_size=96, depth=4, num_heads=4,
                   fullatt_block_indexes=(1, 3), window_size=56)  # 2 merged cells per window side


# --------------------------- host-side metadata ---------------------------


def rot_pos_emb(cfg: QwenVisionConfig, grid_thw: np.ndarray) -> np.ndarray:
    """Per-patch (h, w) rotary angles in merge-group order: (S, head_dim // 2) float32."""
    m = cfg.spatial_merge_size
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    pos_ids = []
    for t, h, w in grid_thw:
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = hpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = wpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        pos_ids.append(np.tile(np.stack([hpos, wpos], axis=-1), (t, 1)))
    pos_ids = np.concatenate(pos_ids, axis=0)
    table = np.outer(np.arange(int(np.max(grid_thw[:, 1:])), dtype=np.float64), inv_freq)
    return table[pos_ids].reshape(pos_ids.shape[0], -1).astype(np.float32)


def get_window_index(cfg: QwenVisionConfig, grid_thw: np.ndarray):
    """The window permutation of merged cells and the attention segments.

    Returns (window_index (S / m^2,), seg_window (S,), seg_full (S,),
    patch_perm (S,)): the segment arrays label each *permuted* patch."""
    m = cfg.spatial_merge_size
    unit = m * m
    vit_win = cfg.window_size // m // cfg.patch_size
    window_index, window_seqlens, full_seqlens = [], [], []
    idx0 = 0
    for t, h, w in grid_thw:
        lh, lw = h // m, w // m
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % vit_win, (-lw) % vit_win
        nwh, nww = (lh + pad_h) // vit_win, (lw + pad_w) // vit_win
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, dtype=np.int64)
        padded[:, :lh, :lw] = index
        padded = padded.reshape(t, nwh, vit_win, nww, vit_win).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nwh * nww, vit_win, vit_win)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        window_index.append(flat[flat != -100] + idx0)
        window_seqlens.extend((seqlens * unit).tolist())
        full_seqlens.extend([int(h * w)] * int(t))
        idx0 += int(t * lh * lw)
    window_index = np.concatenate(window_index)

    def seg_from_lens(lens):
        return np.concatenate([np.full(int(n), i, dtype=np.int32) for i, n in enumerate(lens) if n > 0])

    seg_window = seg_from_lens(window_seqlens)
    # the window permutation reorders patches within their image only, so the
    # image segments (in the original order) permute with the patches
    patch_perm = (window_index[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    seg_full = seg_from_lens(full_seqlens)[patch_perm]
    return window_index, seg_window, seg_full, patch_perm


def patchify(frames_T_C_H_W: torch.Tensor, cfg: QwenVisionConfig) -> tuple[torch.Tensor, np.ndarray]:
    """Normalized frames (T, C, H, W), T a multiple of the temporal patch and
    H, W of patch x merge, -> (pixel_patches (S, C tp P P), grid_thw (1, 3)),
    in HF's Qwen2-VL image processor's order (merge groups of m x m patches
    together, each patch (C, tp, P, P)-major)."""
    T, C, H, W = frames_T_C_H_W.shape
    tp, P, m = cfg.temporal_patch_size, cfg.patch_size, cfg.spatial_merge_size
    gt, gh, gw = T // tp, H // P, W // P
    x = frames_T_C_H_W.reshape(gt, tp, C, gh // m, m, P, gw // m, m, P).permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gt * gh * gw, C * tp * P * P), np.array([[gt, gh, gw]])


# ------------------------------- modules -------------------------------


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        tp, P = cfg.temporal_patch_size, cfg.patch_size
        self.proj = nn.Conv3d(cfg.in_channels, cfg.hidden_size, (tp, P, P), stride=(tp, P, P), bias=False)


class _VisionAttention(nn.Module):
    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class _VisionMLP(nn.Module):
    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size)


class VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.hidden_size)
        self.attn = _VisionAttention(cfg)
        self.norm2 = RMSNorm(cfg.hidden_size)
        self.mlp = _VisionMLP(cfg)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (S, D); cos, sin (S, head_dim) fp32; mask (S, S): True where
        the two patches share an attention segment."""
        cfg, dt = self.cfg, self.cfg.dtype
        S, D = x.shape
        n, hd = cfg.num_heads, cfg.head_dim
        q, k, v = dense(self.attn.qkv, self.norm1(x), dt).view(S, 3, n, hd).unbind(1)

        def rope(t):
            tf = t.float()
            rot = torch.cat([-tf[..., hd // 2:], tf[..., : hd // 2]], dim=-1)
            return (tf * cos[:, None, :] + rot * sin[:, None, :]).to(t.dtype)

        out = attention(rope(q)[None], rope(k)[None], v[None], scale=1.0 / math.sqrt(hd), mask=mask[None, None])
        x = x + dense(self.attn.proj, out[0].to(x.dtype).reshape(S, D), dt)
        h = self.norm2(x)
        mlp = self.mlp
        return x + dense(mlp.down_proj, silu(dense(mlp.gate_proj, h, dt)) * dense(mlp.up_proj, h, dt), dt)


class _PatchMerger(nn.Module):
    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        width = cfg.spatial_merge_size ** 2 * cfg.hidden_size
        self.ln_q = RMSNorm(cfg.hidden_size)
        self.mlp = nn.Sequential(nn.Linear(width, width), nn.GELU(), nn.Linear(width, cfg.out_hidden_size))


class QwenVisionTower(nn.Module):
    """pixel_patches (S, C tp P P) -> merged features (S / m^2, out_hidden)."""

    def __init__(self, cfg: QwenVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.blocks = nn.ModuleList(VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger = _PatchMerger(cfg)

    def forward(self, pixel_patches: torch.Tensor, angles: torch.Tensor, seg_window: torch.Tensor,
                seg_full: torch.Tensor, patch_perm: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        w = self.patch_embed.proj.weight
        x = pixel_patches.to(dt) @ w.reshape(w.shape[0], -1).to(dt).T
        x = x[patch_perm]  # the window permutation, at patch granularity
        ang = angles[patch_perm]
        emb = torch.cat([ang, ang], dim=-1)
        cos, sin = emb.cos(), emb.sin()
        masks = [seg[:, None] == seg[None, :] for seg in (seg_window, seg_full)]
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, masks[i in cfg.fullatt_block_indexes])
        unit = cfg.spatial_merge_size ** 2
        x = self.merger.ln_q(x).reshape(-1, unit * cfg.hidden_size)
        fc1, fc2 = self.merger.mlp[0], self.merger.mlp[2]
        x = dense(fc2, gelu(dense(fc1, x, dt), approximate=False), dt)
        return x[inv_perm]  # merged cells back in their original order


def encode_pixels(tower: QwenVisionTower, pixel_patches, grid_thw: np.ndarray) -> torch.Tensor:
    """The metadata in NumPy on the host, then the tower on its device."""
    cfg = tower.cfg
    dev = tower.blocks[0].attn.qkv.weight.device
    window_index, seg_window, seg_full, patch_perm = get_window_index(cfg, grid_thw)
    put = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    with torch.no_grad():
        return tower(put(pixel_patches), put(rot_pos_emb(cfg, grid_thw)), put(seg_window).long(),
                     put(seg_full).long(), put(patch_perm).long(), put(np.argsort(window_index)).long())


def build_qwen_vision(cfg: QwenVisionConfig, device: torch.device | str = "cuda",
                      seed: Optional[int] = 0) -> QwenVisionTower:
    """The tower built on the meta device, Linear weights stored in
    ``cfg.dtype``, materialised (and with ``seed`` drawn) on ``device``."""
    return build_tower(lambda: QwenVisionTower(cfg), device, cfg.dtype, seed)
