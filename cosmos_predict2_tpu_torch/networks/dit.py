"""MiniTrainDIT — the Cosmos video DiT in PyTorch, dense or with sparse
(neighborhood-attention) blocks, and its temporally causal variant with
KV-cache streaming.

Counterpart of cosmos_predict2_tpu/networks/dit.py (patch embed with the
padding-mask channel, 3D RoPE, sinusoidal timesteps + AdaLN-LoRA, N blocks
of AdaLN-gated self-attention -> cross-attention -> GPT2 MLP with per-head
q/k RMSNorm, final AdaLN layer + unpatchify). Submodules are named after
the reference's torch state-dict keys (``x_embedder.proj.1``,
``t_embedder.1.linear_1``, ``blocks.{i}.adaln_modulation_self_attn.1`` ...)
so utils/checkpoint_convert.py::convert_dit_state_dict maps this module's
``state_dict()`` straight onto the JAX parameter tree.

Numerics follow the reference: fp32 parameters, matmuls in ``cfg.dtype``
(bf16) returning that dtype, norms and AdaLN modulation in fp32.

Sparse blocks (``n_dense_blocks`` >= 0 or ``natten_parameters``, laid out
by :func:`block_layout` as in the reference) run their self-attention
through ops/neighborhood_attention.py with the window, stride and dilation
scaled to the input's token grid (``adaptive_na_parameters``); a one-frame
input (T == 1) takes dense attention there, as in the reference.

Causal (``temporal_causal``, the reference's CausalDIT): self-attention is
block-causal over frames (K1's ``frame_group`` = num_frame_per_block * Hp *
Wp). Given ``kv_caches`` (one per block: head-major k/v ring buffers and the
filled length ``len``, a host int), ``forward`` runs a new frame block
against the cache: each self-attention writes the block's k/v into the
buffers IN PLACE at [len, len + s_new) and attends over [0, len + s_new)
(K5, or K6 with ``cache_na_window_rows`` > 0); it returns (out, caches)
whose ``len`` is advanced. A caller that keeps those caches commits the
block; one that drops them keeps the old ``len``, and the slots written past
it are never read. That is the JAX package's functional update without a
copy of the cache per forward.

Training: with ``remat="block"`` (the default, as the reference) each block
runs under ``torch.utils.checkpoint`` while gradients are recorded: only its
input is kept and the block is computed again in the backward, the
counterpart of ``nn.remat(Block)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cosmos_predict2_tpu_torch.ops.attention import dot_product_attention
from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_kv_cache, flash_attention_kv_cache_window
from cosmos_predict2_tpu_torch.ops.neighborhood_attention import VideoSize, adaptive_na_parameters, neighborhood_attention
from cosmos_predict2_tpu_torch.ops.normalization import layer_norm, rms_norm
from cosmos_predict2_tpu_torch.ops.rope import RopeSpec, apply_rope, rope_angles_3d


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_spatial: int = 2
    patch_temporal: int = 1
    concat_padding_mask: bool = True
    model_channels: int = 2048
    num_blocks: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    crossattn_emb_channels: int = 1024
    use_crossattn_projection: bool = False
    crossattn_proj_in_channels: int = 1024
    use_adaln_lora: bool = True
    adaln_lora_dim: int = 256
    rope_h_extrapolation_ratio: float = 1.0
    rope_w_extrapolation_ratio: float = 1.0
    rope_t_extrapolation_ratio: float = 1.0
    rope_enable_fps_modulation: bool = True
    # sparse (neighborhood) attention: n_dense_blocks -1 all dense, 0 all
    # sparse, k > 0 k dense blocks spread evenly; the sparse blocks use the
    # window / stride / dilation below, scaled from natten_base_size to the
    # input's token grid when it is set
    n_dense_blocks: int = -1
    natten_window: tuple[int, int, int] = (-1, 12, 24)
    natten_stride: tuple[int, int, int] = (1, 1, 1)
    natten_dilation: tuple[int, int, int] = (1, 1, 1)
    natten_base_size: Optional[tuple[int, int, int]] = None
    # per-block (window, stride, dilation, base_size), None for a dense
    # block; when set it overrides n_dense_blocks and the natten_* fields
    natten_parameters: Optional[tuple[Optional[tuple], ...]] = None
    # interactive / causal: frame-block causal self-attention (frame t sees
    # frames <= t, grouped by num_frame_per_block), which KV-cache streaming
    # needs; cache_na_window_rows > 0: in the cached forward each query sees
    # that many key rows (clamped around its own) of every cached frame
    temporal_causal: bool = False
    num_frame_per_block: int = 1
    cache_na_window_rows: int = -1
    timestep_scale: float = 1.0
    # compute dtype for matmuls; norms and modulation stay fp32
    dtype: torch.dtype = torch.bfloat16
    # activation checkpointing of the blocks while training: "block" keeps
    # each block's input and recomputes the block in the backward, "none"
    # keeps every activation ("selective" and "mixed:K" wait for the port)
    remat: str = "block"

    def __post_init__(self):
        if self.remat not in ("block", "none"):
            raise NotImplementedError(f"remat={self.remat!r}: the port has 'block' and 'none'")

    @property
    def head_dim(self) -> int:
        return self.model_channels // self.num_heads

    @property
    def rope_spec(self) -> RopeSpec:
        return RopeSpec(
            head_dim=self.head_dim,
            h_extrapolation_ratio=self.rope_h_extrapolation_ratio,
            w_extrapolation_ratio=self.rope_w_extrapolation_ratio,
            t_extrapolation_ratio=self.rope_t_extrapolation_ratio,
            enable_fps_modulation=self.rope_enable_fps_modulation,
        )


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """y = x W^T (+ b) computed and returned in ``dtype`` (the reference's
    ``Dense``: inputs and parameters cast to the compute dtype)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class RMSNorm(nn.Module):
    """RMSNorm with a learnable weight (eps 1e-6), fp32 inside."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    """Self- or cross-attention: bias-free projections, per-head q/k RMSNorm,
    RoPE on self-attention only."""

    def __init__(self, query_dim: int, context_dim: Optional[int], n_heads: int, head_dim: int, dtype: torch.dtype):
        super().__init__()
        inner = n_heads * head_dim
        ctx_dim = query_dim if context_dim is None else context_dim
        self.n_heads, self.head_dim, self.dtype = n_heads, head_dim, dtype
        self.q_proj = nn.Linear(query_dim, inner, bias=False)
        self.k_proj = nn.Linear(ctx_dim, inner, bias=False)
        self.v_proj = nn.Linear(ctx_dim, inner, bias=False)
        self.q_norm = RMSNorm(head_dim)
        self.k_norm = RMSNorm(head_dim)
        self.output_proj = nn.Linear(inner, query_dim, bias=False)

    def forward(
        self, x: torch.Tensor, context: Optional[torch.Tensor] = None, rope_angles=None, na=None, frame_group: int = 0,
        kv_cache: Optional[dict] = None, cache_window: Optional[tuple] = None,
    ):
        """``na``: (video_size, window, stride, dilation) sends self-attention
        over a video of more than one frame to neighborhood attention;
        ``frame_group`` > 0 makes self-attention frame-block causal.
        ``kv_cache`` (self-attention only): attend over the cache with the
        new block appended in place; ``cache_window`` = ((gh, gw),
        window_rows) selects the row-windowed decode. Returns (out, cache)
        with ``kv_cache``, else out."""
        ctx = x if context is None else context
        heads = lambda t: t.reshape(t.shape[:-1] + (self.n_heads, self.head_dim))
        q = self.q_norm(heads(linear(self.q_proj, x, self.dtype)))
        k = self.k_norm(heads(linear(self.k_proj, ctx, self.dtype)))
        v = heads(linear(self.v_proj, ctx, self.dtype))
        if context is None and rope_angles is not None:
            q = apply_rope(q, rope_angles)
            k = apply_rope(k, rope_angles)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        new_cache = None
        if kv_cache is not None:
            out, new_cache = cached_attention(q, k, v, kv_cache, cache_window)
        elif context is None and na is not None and na[0][0] != 1:
            out = neighborhood_attention(q, k, v, *na)
        else:
            out = dot_product_attention(q, k, v, frame_group=frame_group if context is None else 0)
        out = linear(self.output_proj, out.reshape(out.shape[:-2] + (-1,)), self.dtype)
        return out if kv_cache is None else (out, new_cache)


def cached_attention(q, k, v, kv_cache: dict, cache_window: Optional[tuple]):
    """Write the new block's k/v (B, s_new, H, D) into the head-major ring
    buffers at [len, len + s_new) in place and attend q over [0, len +
    s_new): K6 with ``cache_window`` = ((gh, gw), rows), else K5. Returns
    (out, {"k", "v", "len": len + s_new})."""
    if torch.is_grad_enabled() and q.requires_grad:
        raise NotImplementedError("the cached forward has no backward in the port (self-forcing training waits)")
    kb, vb, n = kv_cache["k"], kv_cache["v"], kv_cache["len"]
    end = n + k.shape[1]
    if end > kb.shape[2]:
        raise ValueError(f"kv cache overflow: {n} + {k.shape[1]} tokens > capacity {kb.shape[2]}")
    kb[:, :, n:end] = k.transpose(1, 2)
    vb[:, :, n:end] = v.transpose(1, 2)
    if cache_window is None:
        out = flash_attention_kv_cache(q, kb, vb, end)
    else:
        out = flash_attention_kv_cache_window(q, kb, vb, end, *cache_window)
    return out, {"k": kb, "v": vb, "len": end}


class GPT2FeedForward(nn.Module):
    """Linear -> GELU (exact) -> Linear, both bias-free."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.layer1 = nn.Linear(d_model, d_ff, bias=False)
        self.layer2 = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.layer2, F.gelu(linear(self.layer1, x, self.dtype)), self.dtype)


def adaln_modulation(dim: int, n_chunks: int, use_lora: bool, lora_dim: int) -> nn.Sequential:
    """SiLU -> Linear(dim -> lora_dim) -> Linear(lora_dim -> n*dim) with
    LoRA, SiLU -> Linear(dim -> n*dim) without; run in fp32."""
    if use_lora:
        return nn.Sequential(
            nn.SiLU(), nn.Linear(dim, lora_dim, bias=False), nn.Linear(lora_dim, n_chunks * dim, bias=False)
        )
    return nn.Sequential(nn.SiLU(), nn.Linear(dim, n_chunks * dim, bias=False))


class Block(nn.Module):
    """x <- x + gate * f(layer_norm(x) * (1 + scale) + shift) for self-attn,
    cross-attn and MLP; (shift, scale, gate) from AdaLN (+ the shared LoRA
    term). A sparse block's self-attention is neighborhood attention with
    ``na_params`` = (window, stride, dilation, base_size)."""

    def __init__(self, cfg: DiTConfig, na_params: Optional[tuple] = None):
        super().__init__()
        d = cfg.model_channels
        self.cfg = cfg
        self.na_params = na_params
        self.self_attn = Attention(d, None, cfg.num_heads, cfg.head_dim, cfg.dtype)
        self.cross_attn = Attention(d, cfg.crossattn_emb_channels, cfg.num_heads, cfg.head_dim, cfg.dtype)
        self.mlp = GPT2FeedForward(d, int(d * cfg.mlp_ratio), cfg.dtype)
        for name in ("self_attn", "cross_attn", "mlp"):
            self.add_module(f"adaln_modulation_{name}", adaln_modulation(d, 3, cfg.use_adaln_lora, cfg.adaln_lora_dim))

    def _mod(self, name: str, emb: torch.Tensor, adaln_lora: Optional[torch.Tensor]):
        out = getattr(self, f"adaln_modulation_{name}")(emb.float())
        if adaln_lora is not None:
            out = out + adaln_lora
        return [c[:, :, None, None, :] for c in out.chunk(3, dim=-1)]  # (B, T, 1, 1, D)

    def forward(self, x, emb, crossattn_emb, rope_angles, adaln_lora, kv_cache=None):
        """Returns x, or (x, cache) with ``kv_cache``."""
        B, T, H, W, D = x.shape
        cfg = self.cfg
        dt = cfg.dtype

        def modulated(shift, scale):
            return (layer_norm(x) * (1.0 + scale) + shift).to(dt)

        na = None
        if self.na_params is not None:
            window, stride, dilation, base = self.na_params
            if base is not None:
                window, stride, dilation = adaptive_na_parameters(window, stride, (T, H, W), base, dilation)
            na = (VideoSize(T, H, W), tuple(window), tuple(stride), tuple(dilation))

        shift, scale, gate = self._mod("self_attn", emb, adaln_lora)
        attn_in = modulated(shift, scale).reshape(B, T * H * W, D)
        if kv_cache is not None:
            window = ((H, W), cfg.cache_na_window_rows) if cfg.cache_na_window_rows > 0 else None
            out, kv_cache = self.self_attn(attn_in, rope_angles=rope_angles, kv_cache=kv_cache, cache_window=window)
        else:
            frame_group = cfg.num_frame_per_block * H * W if cfg.temporal_causal else 0
            out = self.self_attn(attn_in, rope_angles=rope_angles, na=na, frame_group=frame_group)
        x = x + gate.to(x.dtype) * out.reshape(B, T, H, W, D).to(x.dtype)

        shift, scale, gate = self._mod("cross_attn", emb, adaln_lora)
        out = self.cross_attn(modulated(shift, scale).reshape(B, T * H * W, D), context=crossattn_emb.to(dt))
        x = x + gate.to(x.dtype) * out.reshape(B, T, H, W, D).to(x.dtype)

        shift, scale, gate = self._mod("mlp", emb, adaln_lora)
        out = self.mlp(modulated(shift, scale))
        x = x + gate.to(x.dtype) * out.to(x.dtype)
        return x if kv_cache is None else (x, kv_cache)


def block_layout(cfg: DiTConfig) -> list[Optional[tuple]]:
    """Per block, None (dense) or the sparse block's (window, stride,
    dilation, base_size): ``natten_parameters`` when given, else
    ``n_dense_blocks`` dense blocks spread evenly (the reference's
    replace_selfattn_op_with_sparse_attn_op)."""
    n = cfg.num_blocks
    if cfg.natten_parameters is not None:
        if len(cfg.natten_parameters) != n:
            raise ValueError(f"natten_parameters has {len(cfg.natten_parameters)} entries for {n} blocks")
        return [None if p is None else tuple(p) for p in cfg.natten_parameters]
    if cfg.n_dense_blocks == -1:
        return [None] * n
    if cfg.n_dense_blocks == 0:
        dense = set()
    elif cfg.n_dense_blocks == 1:
        dense = {n // 2}
    else:
        dense = set(np.linspace(0, n - 1, cfg.n_dense_blocks, dtype=int).tolist())
    params = (cfg.natten_window, cfg.natten_stride, cfg.natten_dilation, cfg.natten_base_size)
    return [None if i in dense else params for i in range(n)]


def timestep_sinusoid(timesteps_B_T: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Sinusoidal embedding, [cos, sin] order, fp32."""
    half = num_channels // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps_B_T.device) / half
    args = timesteps_B_T.float()[..., None] * torch.exp(exponent)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Timesteps(nn.Module):
    def __init__(self, num_channels: int):
        super().__init__()
        self.num_channels = num_channels

    def forward(self, timesteps_B_T: torch.Tensor) -> torch.Tensor:
        return timestep_sinusoid(timesteps_B_T, self.num_channels)


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear in fp32. With AdaLN-LoRA returns (raw
    sinusoid, 3D LoRA term); without it (mlp output, None)."""

    def __init__(self, in_features: int, out_features: int, use_adaln_lora: bool):
        super().__init__()
        self.use_adaln_lora = use_adaln_lora
        self.linear_1 = nn.Linear(in_features, out_features, bias=not use_adaln_lora)
        n_out = 3 * out_features if use_adaln_lora else out_features
        self.linear_2 = nn.Linear(out_features, n_out, bias=False)

    def forward(self, sample: torch.Tensor):
        emb = self.linear_2(F.silu(self.linear_1(sample)))
        if self.use_adaln_lora:
            return sample, emb
        return emb, None


class PatchEmbed(nn.Module):
    """b c (t r) (h m) (w n) -> b t h w (c r m n), then a bias-free Linear.
    ``proj`` keeps the reference's (Rearrange, Linear) indices."""

    def __init__(self, cfg: DiTConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        patch_dim = in_channels * cfg.patch_temporal * cfg.patch_spatial**2
        self.proj = nn.Sequential(nn.Identity(), nn.Linear(patch_dim, cfg.model_channels, bias=False))

    def forward(self, x_B_C_T_H_W: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x_B_C_T_H_W.shape
        ps, pt = self.cfg.patch_spatial, self.cfg.patch_temporal
        x = x_B_C_T_H_W.reshape(B, C, T // pt, pt, H // ps, ps, W // ps, ps)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, T // pt, H // ps, W // ps, C * pt * ps * ps)
        return linear(self.proj[1], x, self.cfg.dtype)


class FinalLayer(nn.Module):
    """AdaLN (2 chunks) + linear head."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d = cfg.model_channels
        self.cfg = cfg
        self.adaln_modulation = adaln_modulation(d, 2, cfg.use_adaln_lora, cfg.adaln_lora_dim)
        out = cfg.patch_spatial**2 * cfg.patch_temporal * cfg.out_channels
        self.linear = nn.Linear(d, out, bias=False)

    def forward(self, x, emb, adaln_lora):
        d = self.cfg.model_channels
        out = self.adaln_modulation(emb.float())
        if adaln_lora is not None:
            out = out + adaln_lora[:, :, : 2 * d]
        shift, scale = (c[:, :, None, None, :] for c in out.chunk(2, dim=-1))
        x = (layer_norm(x) * (1.0 + scale) + shift).to(self.cfg.dtype)
        return linear(self.linear, x, self.cfg.dtype)


class MiniTrainDIT(nn.Module):
    """The video DiT. x: (B, C, T, H, W); timesteps: (B,) or (B, T)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.model_channels
        in_ch = cfg.in_channels + (1 if cfg.concat_padding_mask else 0)
        self.x_embedder = PatchEmbed(cfg, in_ch)
        self.t_embedder = nn.Sequential(Timesteps(d), TimestepEmbedding(d, d, cfg.use_adaln_lora))
        self.t_embedding_norm = RMSNorm(d)
        if cfg.use_crossattn_projection:
            self.crossattn_proj = nn.Sequential(
                nn.Linear(cfg.crossattn_proj_in_channels, cfg.crossattn_emb_channels, bias=True), nn.GELU()
            )
        layout = block_layout(cfg)
        if cfg.temporal_causal and any(p is not None for p in layout):
            # the JAX package's sparse branch would drop the causal mask (dit.py:344)
            raise NotImplementedError("temporal_causal with sparse (neighborhood-attention) blocks")
        self.blocks = nn.ModuleList(Block(cfg, na_params) for na_params in layout)
        self.final_layer = FinalLayer(cfg)

    def forward(
        self,
        x_B_C_T_H_W: torch.Tensor,
        timesteps_B_T: torch.Tensor,
        crossattn_emb: torch.Tensor,
        fps: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        kv_caches: Optional[list] = None,
        t_start: int = 0,
        intermediate_feature_ids: Optional[tuple[int, ...]] = None,
    ):
        """Returns the output (B, C, T, H, W); with ``kv_caches`` (one per
        block) it runs x as the new frame block at absolute latent frame
        ``t_start`` against the caches and returns (output, caches). With
        ``intermediate_feature_ids`` (the GAN head's taps) it returns
        (output, [the output of each listed block, in block order, as (B,
        L, model_channels)])."""
        cfg = self.cfg
        B, C, T, H, W = x_B_C_T_H_W.shape
        ps, pt = cfg.patch_spatial, cfg.patch_temporal
        if cfg.timestep_scale != 1.0:
            timesteps_B_T = timesteps_B_T * cfg.timestep_scale

        if cfg.concat_padding_mask:
            if padding_mask is None:
                padding_mask = torch.zeros((B, 1, H, W), dtype=x_B_C_T_H_W.dtype, device=x_B_C_T_H_W.device)
            elif padding_mask.shape[-2:] != (H, W):
                padding_mask = F.interpolate(padding_mask.float(), size=(H, W), mode="nearest-exact")
            mask = padding_mask[:, :1, None, :, :].expand(B, 1, T, H, W).to(x_B_C_T_H_W.dtype)
            x_B_C_T_H_W = torch.cat([x_B_C_T_H_W, mask], dim=1)

        x = self.x_embedder(x_B_C_T_H_W)  # (B, T', H', W', D) in cfg.dtype
        Tt, Hp, Wp = T // pt, H // ps, W // ps
        rope_angles = rope_angles_3d(cfg.rope_spec, Tt, Hp, Wp, fps=fps, device=x.device, t_start=t_start)

        if timesteps_B_T.ndim == 1:
            timesteps_B_T = timesteps_B_T[:, None]
        emb, adaln_lora = self.t_embedder[1](self.t_embedder[0](timesteps_B_T))
        emb = self.t_embedding_norm(emb.float())
        if emb.shape[1] == 1 and Tt > 1:
            emb = emb.expand(B, Tt, cfg.model_channels)
            if adaln_lora is not None:
                adaln_lora = adaln_lora.expand(B, Tt, 3 * cfg.model_channels)

        if cfg.use_crossattn_projection:
            crossattn_emb = F.gelu(linear(self.crossattn_proj[0], crossattn_emb, cfg.dtype))

        remat = cfg.remat == "block" and torch.is_grad_enabled() and kv_caches is None
        new_caches = None if kv_caches is None else []
        intermediates = []
        for i, block in enumerate(self.blocks):
            if kv_caches is not None:
                x, cache = block(x, emb, crossattn_emb, rope_angles, adaln_lora, kv_cache=kv_caches[i])
                new_caches.append(cache)
            elif remat:
                x = checkpoint(block, x, emb, crossattn_emb, rope_angles, adaln_lora, use_reentrant=False)
            else:
                x = block(x, emb, crossattn_emb, rope_angles, adaln_lora)
            if intermediate_feature_ids and i in intermediate_feature_ids:
                intermediates.append(x.reshape(B, -1, cfg.model_channels))

        x = self.final_layer(x, emb, adaln_lora)
        # B T H W (p1 p2 t C) -> B C (T t) (H p1) (W p2)
        x = x.reshape(B, Tt, Hp, Wp, ps, ps, pt, cfg.out_channels)
        x = x.permute(0, 7, 1, 6, 2, 4, 3, 5)
        x = x.reshape(B, cfg.out_channels, Tt * pt, Hp * ps, Wp * ps)
        if kv_caches is not None:
            return x, new_caches
        if intermediate_feature_ids:
            return x, intermediates
        return x


@torch.no_grad()
def cast_matmul_weights(net: MiniTrainDIT) -> MiniTrainDIT:
    """Store the weights that the DiT multiplies in ``cfg.dtype`` (patch
    embed, attention projections, MLP, final linear, text projection) in
    that dtype, once, for serving: :func:`linear` casts them on every call
    otherwise. The outputs do not change (the same rounding, made once);
    the AdaLN and timestep layers stay fp32, as they compute in fp32."""
    dtype = net.cfg.dtype
    layers = [net.x_embedder.proj[1], net.final_layer.linear]
    if net.cfg.use_crossattn_projection:
        layers.append(net.crossattn_proj[0])
    for block in net.blocks:
        for attn in (block.self_attn, block.cross_attn):
            layers += [attn.q_proj, attn.k_proj, attn.v_proj, attn.output_proj]
        layers += [block.mlp.layer1, block.mlp.layer2]
    for layer in layers:
        layer.weight.data = layer.weight.data.to(dtype)
    return net


@torch.no_grad()
def init_dit_weights(net: MiniTrainDIT, generator: torch.Generator) -> MiniTrainDIT:
    """Seeded random weights: every Linear weight ~ truncated normal with
    std 1/sqrt(fan_in) (cut at 3 std), biases 0, norm weights 1. The
    generator must live on the parameters' device."""
    for module in net.modules():
        if isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features)
            nn.init.trunc_normal_(module.weight, 0.0, std, -3 * std, 3 * std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
    return net


def build_dit(cfg: DiTConfig, device: torch.device | str, seed: int, trainable: bool = False) -> MiniTrainDIT:
    """A MiniTrainDIT with seeded random fp32 weights, made on ``device``:
    frozen for serving, or with every parameter trainable."""
    with torch.device("meta"):
        net = MiniTrainDIT(cfg)
    net = net.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_dit_weights(net, gen).train(trainable).requires_grad_(trainable)
