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

Under autograd (self-forcing training) the cached self-attention is
:class:`CachedAttention`: the new block's k/v are inputs of the Function and
take the gradient of their rows [len, len + s_new); the prefix [0, len)
takes none (the JAX rollout's ``stop_gradient`` on the caches). The
backward reads the prefix from the buffers themselves, which later forwards
keep writing in place at or above ``len``, so autograd's version counter
cannot guard it: every cache write is logged (:func:`cache_write`) and the
backward raises if a write since its forward began below ``len`` (a window
slide, or a cache reused from a lower fill). That keeps no copy of the
prefix.

Training: with ``remat="block"`` (the default, as the reference) each block
runs under ``torch.utils.checkpoint`` while gradients are recorded: only its
input is kept and the block is computed again in the backward, the
counterpart of ``nn.remat(Block)``. ``"selective"`` also keeps each
attention call's result (out and lse, ops/flash_attention.py::SavedAttention),
so the recompute runs the rest of the block and no attention forward;
``"mixed:K"`` is selective on blocks < K and block remat after (``"mixed"``:
K = num_blocks // 2); ``"none"`` keeps every activation. A cached forward
under autograd (the self-forcing rollout) takes block remat under any
setting but ``"none"``: the recompute writes the block's k/v into the
cache again at the same rows, which hold that block's committed k/v by
then and which no graph still to run reads (the guard below raises if one
does). The JAX package keeps every activation of its cached forward;
here each recorded forward would also keep the bf16 copy of every matmul
weight that ``linear`` makes (~4 GB for the 2B), beside three fp32 nets
in self-forcing.

The post-trained variants: ``concat_condition_mask`` adds the condition
mask as an input channel; ``action_dim`` adds two action MLPs to the
timestep embedding and the AdaLN-LoRA term; ``camera_dim`` gives each
block a ``cam_encoder`` whose projection of the per-token camera input is
added to the self-attention's normed input; ``n_views`` > 1 packs views
view-major on T, tiles one view's RoPE table over them, sends each view's
tokens to its own caption slice in the cross-attention (views folded into
the batch) and, with ``concat_view_embedding``, appends learned view
channels; ``enable_cross_view_attn`` adds :class:`CrossViewAttention`
between self- and cross-attention.

LoRA: a Linear that carries an ``adapter`` attribute (a module of
training/lora.py, not registered in this net) adds ``adapter(x)`` to its
output in :func:`linear`, unmerged: the frozen weight gets no gradient.
Under tensor parallelism the adapter is laid out as its layer and joins
its product's collectives (parallel/mesh.py::tp_linear).

Context parallelism (:func:`set_context_parallel`, the JAX package's
``cp_axis``): every rank of the cp group holds the same replicated inputs
and runs the same sampler; the net takes its rank's slab of the patch
tokens on entry (parallel/mesh.py::TokenSlab: whole latent frames, or whole
rows of one frame for a streaming block of one frame), with the slab's RoPE
angles and timestep embeddings, and all-gathers the output on exit. Inside,
self-attention runs by ``cfg.cp_strategy``: Ulysses (parallel/cp.py: K1, or
K10 on a sparse block) or ring (parallel/ring_attention.py: K1 per block);
a cached forward takes the head-sharded decode
(``ulysses_kv_cache_attention``: K5 / K6 over (B, H/c, S_max, D) buffers);
cross-attention stays local, the caption being replicated. A multiview
slab may cross views: its frames split into view segments, each attending
its own view's caption (one K1 call for equal segments, else one a
segment), and cross-view attention, which needs the same frame of other
views, moves to the head-sharded layout (parallel/cp.py::scatter_heads:
every token of H/c heads on each rank) for its per-view K1 calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint, noop_context_fn

from cosmos_predict2_tpu_torch.ops.attention import dot_product_attention
from cosmos_predict2_tpu_torch.ops.flash_attention import SavedAttention, kv_cache_attention, kv_cache_vjp
from cosmos_predict2_tpu_torch.ops.neighborhood_attention import VideoSize, adaptive_na_parameters, neighborhood_attention
from cosmos_predict2_tpu_torch.ops.normalization import layer_norm, rms_norm
from cosmos_predict2_tpu_torch.ops.rope import RopeSpec, apply_rope, rope_angles_3d
from cosmos_predict2_tpu_torch.parallel import comm
from cosmos_predict2_tpu_torch.parallel.cp import gather_heads, scatter_heads, ulysses_attention, ulysses_kv_cache_attention
from cosmos_predict2_tpu_torch.parallel.mesh import TokenSlab, divisible_cp, token_slab, tp_linear, tp_local
from cosmos_predict2_tpu_torch.parallel.ring_attention import ring_attention


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
    # camera conditioning: a per-block bias-free cam_encoder (camera_dim ->
    # model_channels) adds the per-token camera embedding (Plücker rays,
    # (B, Tt, Hp, Wp, camera_dim)) to the self-attention's normed input
    camera_dim: Optional[int] = None
    # multiview: the latent T axis packs n_views views view-major (V Tv);
    # RoPE repeats per view and each view cross-attends its own
    # tokens_per_view tokens of the caption (B, V tokens_per_view, D);
    # concat_view_embedding adds a learned (n_cameras_emb,
    # view_condition_dim) table as input channels, after the mask channels
    n_views: int = 1
    concat_view_embedding: bool = False
    n_cameras_emb: int = 7
    view_condition_dim: int = 0
    tokens_per_view: int = 512
    # cross-view attention between self- and cross-attention: each view's
    # tokens attend the same frame's tokens of the views in
    # cross_view_attn_map[view]
    enable_cross_view_attn: bool = False
    cross_view_attn_map: Optional[tuple[tuple[int, ...], ...]] = None
    # action conditioning: the (B, 1, T, H, W) condition mask as an extra
    # input channel, and two GELU-tanh MLPs embedding the actions into the
    # timestep embedding (B_D) and the AdaLN-LoRA term (B_3D): one embedding
    # of the whole chunk (action_dim * num_action_per_chunk inputs), or with
    # action_per_latent_frame one per latent frame (action_dim *
    # num_action_per_latent_frame inputs), frame 0 zero-padded
    concat_condition_mask: bool = False
    action_dim: Optional[int] = None
    num_action_per_chunk: int = 12
    action_per_latent_frame: bool = False
    num_action_per_latent_frame: int = 4
    timestep_scale: float = 1.0
    # compute dtype for matmuls; norms and modulation stay fp32
    dtype: torch.dtype = torch.bfloat16
    # activation checkpointing of the blocks while training: "block" keeps
    # each block's input and recomputes the block in the backward,
    # "selective" also keeps the attention results, "mixed:K" is selective
    # on blocks < K and "block" after, "none" keeps every activation
    remat: str = "block"
    # self-attention under context parallelism (set_context_parallel):
    # "ulysses" (all-to-all head scatter, cp must divide num_heads) or
    # "ring" (K/V hops around the cp ranks, any cp degree; forward only)
    cp_strategy: str = "ulysses"

    def __post_init__(self):
        self.selective_blocks  # validates remat
        if self.cp_strategy not in ("ulysses", "ring"):
            raise ValueError(f"cp_strategy={self.cp_strategy!r}: want 'ulysses' or 'ring'")

    @property
    def selective_blocks(self) -> int:
        """How many leading blocks run selective remat."""
        if self.remat in ("block", "none"):
            return 0
        if self.remat == "selective":
            return self.num_blocks
        kind, _, k = self.remat.partition(":")
        if kind != "mixed" or not (k == "" or k.isdigit()):
            raise ValueError(f"remat={self.remat!r}: want 'none', 'block', 'selective', 'mixed' or 'mixed:K'")
        return int(k) if k else self.num_blocks // 2

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
    ``Dense``: inputs and parameters cast to the compute dtype), plus
    ``layer.adapter(x)`` when the layer carries a LoRA adapter. A
    tensor-parallel layer (parallel/mesh.py::parallelize) runs through
    :func:`tp_linear` on the local tensors, its adapter with it."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    x = x.to(dtype)
    weight = layer.weight.to(dtype)
    adapter = layer.__dict__.get("adapter")
    if isinstance(weight, DTensor):
        return tp_linear(x, weight, bias, adapter)
    y = F.linear(x, weight, bias)
    return y if adapter is None else y + adapter(x)


class RMSNorm(nn.Module):
    """RMSNorm with a learnable weight (eps 1e-6), fp32 inside."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, tp_local(self.weight), self.eps)


@dataclasses.dataclass(frozen=True)
class ContextParallel:
    """A forward's context parallelism: the cp process group, the
    self-attention strategy and this rank's slab of the (T', H', W') patch
    token grid."""

    group: object
    strategy: str
    slab: TokenSlab


class Attention(nn.Module):
    """Self- or cross-attention: bias-free projections, per-head q/k RMSNorm,
    RoPE on self-attention only. Under tensor parallelism the projections
    give this rank's heads; the head count is read from their width."""

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
        kv_cache: Optional[dict] = None, cache_window: Optional[tuple] = None, cp: Optional[ContextParallel] = None,
    ):
        """``na``: (video_size, window, stride, dilation) sends self-attention
        over a video of more than one frame to neighborhood attention;
        ``frame_group`` > 0 makes self-attention frame-block causal.
        ``kv_cache`` (self-attention only): attend over the cache with the
        new block appended in place; ``cache_window`` = ((gh, gw),
        window_rows) selects the row-windowed decode. With ``cp`` x is this
        rank's slab of the tokens and self-attention runs context-parallel
        (``na`` and ``frame_group`` of the whole sequence; the cache a head
        shard). Returns (out, cache) with ``kv_cache``, else out."""
        ctx = x if context is None else context
        heads = lambda t: t.reshape(t.shape[:-1] + (-1, self.head_dim))
        q = self.q_norm(heads(linear(self.q_proj, x, self.dtype)))
        k = self.k_norm(heads(linear(self.k_proj, ctx, self.dtype)))
        v = heads(linear(self.v_proj, ctx, self.dtype))
        if context is None and rope_angles is not None:
            q = apply_rope(q, rope_angles)
            k = apply_rope(k, rope_angles)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        new_cache = None
        if cp is not None and context is None:
            if kv_cache is not None:
                out, new_cache = ulysses_kv_cache_attention(q, k, v, kv_cache, cp.group, cache_window)
            elif na is not None and na[0][0] != 1:
                out = ulysses_attention(q, k, v, cp.group, na=na)
            elif cp.strategy == "ring":
                out = ring_attention(q, k, v, cp.group, frame_group=frame_group)
            else:
                out = ulysses_attention(q, k, v, cp.group, frame_group=frame_group)
        elif kv_cache is not None:
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
    (out, {"k", "v", "len": len + s_new}). Under autograd the same, through
    :class:`CachedAttention`."""
    kb, vb, n = kv_cache["k"], kv_cache["v"], kv_cache["len"]
    end = n + k.shape[1]
    if end > kb.shape[2]:
        raise ValueError(f"kv cache overflow: {n} + {k.shape[1]} tokens > capacity {kb.shape[2]}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = CachedAttention.apply(q, k, v, kb, vb, n, cache_window)
    else:
        write_block(kb, vb, n, k, v)
        out = kv_cache_attention(q, kb, vb, end, cache_window)
    return out, {"k": kb, "v": vb, "len": end}


def write_block(kb: torch.Tensor, vb: torch.Tensor, n: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """k/v (B, s_new, H, D) into the head-major buffers at [n, n + s_new), logged."""
    with cache_write(kb, n), cache_write(vb, n):
        kb[:, :, n:n + k.shape[1]] = k.transpose(1, 2)
        vb[:, :, n:n + v.shape[1]] = v.transpose(1, 2)


@contextlib.contextmanager
def cache_write(buf: torch.Tensor, first_row: int):
    """Log the in-place write, inside this context, of rows >= ``first_row``
    of a cache buffer. The log on the buffer keeps (version after, first
    row) pairs whose rows rise with the version (a write pops the entries at
    or above its row); a write found on the way in that the log lacks is
    logged as a write of every row."""
    before = buf._version
    yield
    log = buf.__dict__.setdefault("_cache_writes", [])
    if before != (log[-1][0] if log else 0):
        log.clear()
        log.append((before, 0))
    while log and log[-1][1] >= first_row:
        log.pop()
    log.append((buf._version, first_row))


def check_cache_prefix(buf: torch.Tensor, rows: int, version: int) -> None:
    """Raise unless rows [0, ``rows``) of a cache buffer still hold what they
    held at its ``version``: every write since then was logged by
    :func:`cache_write` and began at or above ``rows``."""
    if rows == 0 or buf._version == version:
        return
    log = buf.__dict__.get("_cache_writes", [])
    if not log or log[-1][0] != buf._version:
        raise RuntimeError("a kv cache buffer was written in place outside the cache's own writes while a graph "
                           "reads its prefix: the cached attention has no gradient")
    first = next(row for v, row in log if v > version)
    if first < rows:
        raise RuntimeError(f"a kv cache buffer was written from row {first}, below the fill {rows} that a graph "
                           "reads (a window slide, or a cache reused from a lower fill), between the cached "
                           "attention's forward and its backward")


class CachedAttention(torch.autograd.Function):
    """:func:`cached_attention` under autograd: the forward writes k/v into
    the buffers at [n, n + s_new) and launches K5 / K6 as the inference route
    does; the backward checks the prefix [0, n) (:func:`check_cache_prefix`)
    and recomputes through the plain masked reference over [prefix | k, v]
    (ops/flash_attention.py::kv_cache_vjp), the JAX package's VJP. q, k and v
    take gradients; the buffers take none.
    ``CachedAttention.apply(q, k, v, k_buf, v_buf, n, cache_window)``."""

    @staticmethod
    def forward(ctx, q, k, v, kb, vb, n: int, cache_window: Optional[tuple]):
        write_block(kb, vb, n, k, v)
        ctx.save_for_backward(q, k, v)
        ctx.buffers, ctx.versions = (kb, vb), (kb._version, vb._version)
        ctx.n, ctx.cache_window = n, cache_window
        return kv_cache_attention(q, kb, vb, n + k.shape[1], cache_window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        n = ctx.n
        for buf, version in zip(ctx.buffers, ctx.versions):
            check_cache_prefix(buf, n, version)
        kb, vb = (torch.cat([buf[:, :, :n], t.transpose(1, 2).to(buf.dtype)], dim=2)
                  for buf, t in zip(ctx.buffers, (k, v)))
        dq, dk, dv = kv_cache_vjp(q, kb, vb, kb.shape[2], do, ctx.cache_window)
        dk, dv = (d[:, :, n:].transpose(1, 2).to(t.dtype) for d, t in ((dk, k), (dv, v)))
        return dq, dk, dv, None, None, None, None


class CrossViewAttention(nn.Module):
    """Per-frame attention from each view to its neighbour views: shared
    bias-free q/k/v/o projections, per-head q/k RMSNorm, no RoPE. The map is
    static, so each view runs one dense attention (K1 on the card) over its
    neighbours' same-frame tokens, with no padding or mask; a view without
    neighbours gets zeros. The JAX package zero-initialises ``output_proj``
    (the path starts as an identity residual)."""

    def __init__(self, dim: int, n_heads: int, head_dim: int, attn_map: tuple[tuple[int, ...], ...],
                 dtype: torch.dtype):
        super().__init__()
        inner = n_heads * head_dim
        self.n_heads, self.head_dim, self.attn_map, self.dtype = n_heads, head_dim, attn_map, dtype
        self.q_proj = nn.Linear(dim, inner, bias=False)
        self.k_proj = nn.Linear(dim, inner, bias=False)
        self.v_proj = nn.Linear(dim, inner, bias=False)
        self.q_norm = RMSNorm(head_dim)
        self.k_norm = RMSNorm(head_dim)
        self.output_proj = nn.Linear(inner, dim, bias=False)

    def forward(self, x_B_V_T_H_W_D: torch.Tensor) -> torch.Tensor:
        B, V, Tv, H, W, D = x_B_V_T_H_W_D.shape
        q, k, v = self._project(x_B_V_T_H_W_D.reshape(B, V, Tv, H * W, D))
        out = linear(self.output_proj, self._attend(q, k, v), self.dtype)
        return out.reshape(B, V, Tv, H, W, D)

    def forward_slab(self, x_B_T_H_W_D: torch.Tensor, n_views: int, group) -> torch.Tensor:
        """Context-parallel: x is this rank's slab of whole frames of the
        packed (V Tv) axis over the cp ``group``. The projections and norms
        run on the slab; q, k and v move to the head-sharded layout
        (parallel/cp.py::scatter_heads: every token of this rank's H/c
        heads), where each view attends its neighbours as in
        :meth:`forward`, and back before the output projection."""
        B, T, H, W, D = x_B_T_H_W_D.shape
        L = H * W
        q, k, v = (scatter_heads(t.contiguous(), group) for t in self._project(x_B_T_H_W_D.reshape(B, T * L, D)))
        frames = q.shape[1] // L
        shape = (B, n_views, frames // n_views, L) + q.shape[2:]
        out = self._attend(*(t.reshape(shape) for t in (q, k, v)))
        out = gather_heads(out.reshape(B, frames * L, q.shape[2], -1), group)
        return linear(self.output_proj, out.reshape(B, T * L, -1), self.dtype).reshape(B, T, H, W, D)

    def _project(self, x: torch.Tensor):
        """q (normed), k (normed) and v of x (..., D), each (..., h, head_dim)."""
        heads = lambda t: t.reshape(t.shape[:-1] + (-1, self.head_dim))
        q = self.q_norm(heads(linear(self.q_proj, x, self.dtype)))
        k = self.k_norm(heads(linear(self.k_proj, x, self.dtype)))
        return q, k, heads(linear(self.v_proj, x, self.dtype))

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """q, k, v (B, V, Tv, L, h, d) -> (B, V, Tv, L, h d): each view's
        tokens over its neighbours' same-frame tokens, one K1 call a view."""
        B, V, Tv, L, h, d = q.shape  # h: this rank's heads under tensor or context parallelism
        outs = []
        for view in range(V):
            neighbors = [n for n in self.attn_map[view] if 0 <= n < V]
            if not neighbors:
                outs.append(torch.zeros((B, Tv, L, h * d), dtype=q.dtype, device=q.device))
                continue
            q_v = q[:, view].reshape(B * Tv, L, h, d).contiguous()
            k_v = torch.cat([k[:, n] for n in neighbors], dim=2).reshape(B * Tv, len(neighbors) * L, h, d)
            v_v = torch.cat([v[:, n] for n in neighbors], dim=2).reshape(B * Tv, len(neighbors) * L, h, d)
            outs.append(dot_product_attention(q_v, k_v.contiguous(), v_v.contiguous()).reshape(B, Tv, L, h * d))
        return torch.stack(outs, dim=1)


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
        if cfg.camera_dim is not None:
            self.cam_encoder = nn.Linear(cfg.camera_dim, d, bias=False)
        if cfg.enable_cross_view_attn and cfg.n_views > 1:
            if cfg.cross_view_attn_map is None:
                raise ValueError("enable_cross_view_attn needs cross_view_attn_map")
            self.ln_cross_view_scale = nn.Parameter(torch.ones(d))
            self.ln_cross_view_bias = nn.Parameter(torch.zeros(d))
            self.cross_view_attn = CrossViewAttention(d, cfg.num_heads, cfg.head_dim, cfg.cross_view_attn_map, cfg.dtype)

    def _mod(self, name: str, emb: torch.Tensor, adaln_lora: Optional[torch.Tensor]):
        out = getattr(self, f"adaln_modulation_{name}")(emb.float())
        if adaln_lora is not None:
            out = out + adaln_lora
        return [c[:, :, None, None, :] for c in out.chunk(3, dim=-1)]  # (B, T, 1, 1, D)

    def forward(self, x, emb, crossattn_emb, rope_angles, adaln_lora, kv_cache=None, camera=None, cp=None):
        """Returns x, or (x, cache) with ``kv_cache``. ``camera`` (B, T, H, W,
        camera_dim) goes through ``cam_encoder`` when the block has one.
        With ``cp`` (a :class:`ContextParallel`) x is this rank's slab; the
        attention geometry is the whole grid's."""
        B, T, H, W, D = x.shape
        cfg = self.cfg
        dt = cfg.dtype
        V = cfg.n_views
        Tg, Hg, Wg = (T, H, W) if cp is None else cp.slab.grid

        def modulated(shift, scale):
            return (layer_norm(x) * (1.0 + scale) + shift).to(dt)

        na = None
        if self.na_params is not None:
            window, stride, dilation, base = self.na_params
            if base is not None:
                window, stride, dilation = adaptive_na_parameters(window, stride, (Tg, Hg, Wg), base, dilation)
            na = (VideoSize(Tg, Hg, Wg), tuple(window), tuple(stride), tuple(dilation))

        shift, scale, gate = self._mod("self_attn", emb, adaln_lora)
        normed = modulated(shift, scale)
        if camera is not None and cfg.camera_dim is not None:
            normed = normed + linear(self.cam_encoder, camera, dt)
        attn_in = normed.reshape(B, T * H * W, D)
        if kv_cache is not None:
            window = ((Hg, Wg), cfg.cache_na_window_rows) if cfg.cache_na_window_rows > 0 else None
            out, kv_cache = self.self_attn(attn_in, rope_angles=rope_angles, kv_cache=kv_cache, cache_window=window,
                                           cp=cp)
        else:
            frame_group = cfg.num_frame_per_block * Hg * Wg if cfg.temporal_causal else 0
            out = self.self_attn(attn_in, rope_angles=rope_angles, na=na, frame_group=frame_group, cp=cp)
        x = x + gate.to(x.dtype) * out.reshape(B, T, H, W, D).to(x.dtype)

        if hasattr(self, "cross_view_attn"):
            # affine LayerNorm -> cross-view attention -> ungated residual
            normed = (layer_norm(x) * self.ln_cross_view_scale + self.ln_cross_view_bias).to(dt)
            if cp is None:
                out = self.cross_view_attn(normed.reshape(B, V, T // V, H, W, D))
            else:
                out = self.cross_view_attn.forward_slab(normed, V, cp.group)
            x = x + out.reshape(B, T, H, W, D).to(x.dtype)

        shift, scale, gate = self._mod("cross_attn", emb, adaln_lora)
        attn_in, ctx = modulated(shift, scale), crossattn_emb.to(dt)
        if V > 1:
            out = self._per_view_cross_attention(attn_in, ctx, cp)
        else:
            out = self.cross_attn(attn_in.reshape(B, T * H * W, D), context=ctx)
        x = x + gate.to(x.dtype) * out.reshape(B, T, H, W, D).to(x.dtype)

        shift, scale, gate = self._mod("mlp", emb, adaln_lora)
        out = self.mlp(modulated(shift, scale))
        x = x + gate.to(x.dtype) * out.to(x.dtype)
        return x if kv_cache is None else (x, kv_cache)

    def _per_view_cross_attention(self, x: torch.Tensor, ctx: torch.Tensor, cp: Optional[ContextParallel]):
        """Each view's tokens of x (B, T, H, W, D) attend that view's
        ``tokens_per_view`` tokens of the caption ctx (B, V M, D'). The
        frames of x (all of them, or a cp slab of whole frames that may
        cross views) split into view segments; equal segments run as one
        call with the segments in the batch, (n B), else one call a
        segment. Returns (B, T H W, D)."""
        cfg = self.cfg
        B, T, H, W, D = x.shape
        V, M = cfg.n_views, cfg.tokens_per_view
        first, whole = (0, T) if cp is None else (cp.slab.frames[0], cp.slab.grid[0])
        per_view = whole // V
        segments = []  # (view, first frame, last + 1), local
        t = first
        while t < first + T:
            view = t // per_view
            end = min((view + 1) * per_view, first + T)
            segments.append((view, t - first, end - first))
            t = end
        ctx = ctx.reshape(B, V, M, -1)
        if len({hi - lo for _, lo, hi in segments}) > 1:
            outs = [self.cross_attn(x[:, lo:hi].reshape(B, -1, D), context=ctx[:, view]) for view, lo, hi in segments]
            return torch.cat(outs, dim=1)
        n, L = len(segments), T // len(segments) * H * W
        q_in = x.reshape(B, n, L, D).transpose(0, 1).reshape(n * B, L, D)
        c = ctx[:, segments[0][0]:segments[-1][0] + 1].transpose(0, 1).reshape(n * B, M, -1)
        return self.cross_attn(q_in, context=c).reshape(n, B, L, D).transpose(0, 1).reshape(B, T * H * W, D)


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


class ActionMlp(nn.Module):
    """Linear -> GELU (tanh) -> Linear, with biases, in fp32."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x.float()), approximate="tanh"))


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
        in_ch = cfg.in_channels + int(cfg.concat_condition_mask) + int(cfg.concat_padding_mask)
        if self.view_embedding_channels:
            self.view_embeddings = nn.Embedding(cfg.n_cameras_emb, cfg.view_condition_dim)
            in_ch += cfg.view_condition_dim
        self.x_embedder = PatchEmbed(cfg, in_ch)
        self.t_embedder = nn.Sequential(Timesteps(d), TimestepEmbedding(d, d, cfg.use_adaln_lora))
        self.t_embedding_norm = RMSNorm(d)
        if cfg.action_dim is not None:
            per = cfg.num_action_per_latent_frame if cfg.action_per_latent_frame else cfg.num_action_per_chunk
            self.action_embedder_B_D = ActionMlp(cfg.action_dim * per, 4 * d, d)
            self.action_embedder_B_3D = ActionMlp(cfg.action_dim * per, 4 * d, 3 * d)
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
        self.cp_group = None  # set_context_parallel

    @property
    def view_embedding_channels(self) -> bool:
        return self.cfg.concat_view_embedding and self.cfg.n_views > 1

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
        condition_mask: Optional[torch.Tensor] = None,
        action: Optional[torch.Tensor] = None,
        camera: Optional[torch.Tensor] = None,
        view_indices_B_T: Optional[torch.Tensor] = None,
    ):
        """Returns the output (B, C, T, H, W); with ``kv_caches`` (one per
        block) it runs x as the new frame block at absolute latent frame
        ``t_start`` against the caches and returns (output, caches). With
        ``intermediate_feature_ids`` (the GAN head's taps) it returns
        (output, [the output of each listed block, in block order, as (B,
        L, model_channels)]).

        The post-trained variants' inputs: ``condition_mask`` (B, 1, T, H,
        W) for ``concat_condition_mask`` (zeros when None), ``action`` (B,
        T_act, action_dim) for ``action_dim`` and ``camera`` (B, Tt, Hp, Wp,
        camera_dim) for ``camera_dim`` (no camera term when None). With
        ``n_views`` > 1 the caption holds ``tokens_per_view`` tokens per
        view, view-major, and view v takes view embedding v, or with
        ``view_indices_B_T`` (B, T) the embedding of each (view, frame)'s
        index, clipped to ``n_cameras_emb - 1``."""
        cfg = self.cfg
        B, C, T, H, W = x_B_C_T_H_W.shape
        ps, pt = cfg.patch_spatial, cfg.patch_temporal
        if cfg.concat_condition_mask:
            if condition_mask is None:
                condition_mask = torch.zeros((B, 1, T, H, W), dtype=x_B_C_T_H_W.dtype, device=x_B_C_T_H_W.device)
            x_B_C_T_H_W = torch.cat([x_B_C_T_H_W, condition_mask.to(x_B_C_T_H_W.dtype)], dim=1)
        if cfg.timestep_scale != 1.0:
            timesteps_B_T = timesteps_B_T * cfg.timestep_scale

        if cfg.concat_padding_mask:
            if padding_mask is None:
                padding_mask = torch.zeros((B, 1, H, W), dtype=x_B_C_T_H_W.dtype, device=x_B_C_T_H_W.device)
            elif padding_mask.shape[-2:] != (H, W):
                padding_mask = F.interpolate(padding_mask.float(), size=(H, W), mode="nearest-exact")
            mask = padding_mask[:, :1, None, :, :].expand(B, 1, T, H, W).to(x_B_C_T_H_W.dtype)
            x_B_C_T_H_W = torch.cat([x_B_C_T_H_W, mask], dim=1)
        V = cfg.n_views
        if V > 1 and T % V:
            raise ValueError(f"a {V}-view input packs {V} views of equal length on T, got {T} latent frames")
        if V > 1 and crossattn_emb.shape[1] != V * cfg.tokens_per_view:
            raise ValueError(f"a {V}-view caption holds {V} x tokens_per_view = {V * cfg.tokens_per_view} tokens, "
                             f"got {crossattn_emb.shape[1]}")
        if self.view_embedding_channels:  # channels [x | cond | pad | view]
            if view_indices_B_T is None:
                idx = torch.arange(V, device=x_B_C_T_H_W.device).clamp(0, cfg.n_cameras_emb - 1)
                ve = self.view_embeddings.weight[idx][None, :, None].expand(B, V, T // V, -1).reshape(B, T, -1)
            else:
                ve = self.view_embeddings.weight[view_indices_B_T.long().clamp(0, cfg.n_cameras_emb - 1)]
            ve = ve.permute(0, 2, 1)[..., None, None].expand(B, -1, T, H, W)
            x_B_C_T_H_W = torch.cat([x_B_C_T_H_W, ve.to(x_B_C_T_H_W.dtype)], dim=1)

        x = self.x_embedder(x_B_C_T_H_W)  # (B, T', H', W', D) in cfg.dtype
        Tt, Hp, Wp = T // pt, H // ps, W // ps
        if V > 1:  # one view's table, tiled over the views
            rope_angles = rope_angles_3d(cfg.rope_spec, Tt // V, Hp, Wp, fps=fps, device=x.device).repeat(V, 1)
        else:
            rope_angles = rope_angles_3d(cfg.rope_spec, Tt, Hp, Wp, fps=fps, device=x.device, t_start=t_start)

        if timesteps_B_T.ndim == 1:
            timesteps_B_T = timesteps_B_T[:, None]
        emb, adaln_lora = self.t_embedder[1](self.t_embedder[0](timesteps_B_T))
        if cfg.action_dim is not None:
            emb, adaln_lora = self._add_action(emb, adaln_lora, action)
        emb = self.t_embedding_norm(emb.float())
        if emb.shape[1] == 1 and Tt > 1:
            emb = emb.expand(B, Tt, cfg.model_channels)
            if adaln_lora is not None:
                adaln_lora = adaln_lora.expand(B, Tt, 3 * cfg.model_channels)

        if cfg.use_crossattn_projection:
            crossattn_emb = F.gelu(linear(self.crossattn_proj[0], crossattn_emb, cfg.dtype))

        cp = self._context_parallel((Tt, Hp, Wp), cached=kv_caches is not None)
        if cp is not None:  # this rank's slab of the tokens, its angles and its frames' embeddings
            x = cp.slab.take(x)
            t0, t1 = cp.slab.tokens
            rope_angles = rope_angles[t0:t1]
            emb = cp.slab.take_frames(emb)
            if adaln_lora is not None:
                adaln_lora = cp.slab.take_frames(adaln_lora)
            if camera is not None:
                camera = cp.slab.take(camera)

        remat = cfg.remat != "none" and torch.is_grad_enabled()
        new_caches = None if kv_caches is None else []
        intermediates = []
        for i, block in enumerate(self.blocks):
            if kv_caches is not None:
                if remat:  # block remat under any remat setting: the cached attention keeps nothing to reuse
                    x, cache = checkpoint(block, x, emb, crossattn_emb, rope_angles, adaln_lora, use_reentrant=False,
                                          kv_cache=kv_caches[i], cp=cp)
                else:
                    x, cache = block(x, emb, crossattn_emb, rope_angles, adaln_lora, kv_cache=kv_caches[i], cp=cp)
                new_caches.append(cache)
            elif remat:
                context_fn = (lambda: SavedAttention().contexts()) if i < cfg.selective_blocks else noop_context_fn
                x = checkpoint(block, x, emb, crossattn_emb, rope_angles, adaln_lora, use_reentrant=False,
                               context_fn=context_fn, camera=camera, cp=cp)
            else:
                x = block(x, emb, crossattn_emb, rope_angles, adaln_lora, camera=camera, cp=cp)
            if intermediate_feature_ids and i in intermediate_feature_ids:
                xi = x if cp is None else cp.slab.gather(x, cp.group)
                intermediates.append(xi.reshape(B, -1, cfg.model_channels))

        x = self.final_layer(x, emb, adaln_lora)
        if cp is not None:
            x = cp.slab.gather(x, cp.group)
        # B T H W (p1 p2 t C) -> B C (T t) (H p1) (W p2)
        x = x.reshape(B, Tt, Hp, Wp, ps, ps, pt, cfg.out_channels)
        x = x.permute(0, 7, 1, 6, 2, 4, 3, 5)
        x = x.reshape(B, cfg.out_channels, Tt * pt, Hp * ps, Wp * ps)
        if kv_caches is not None:
            return x, new_caches
        if intermediate_feature_ids:
            return x, intermediates
        return x


    def _context_parallel(self, grid: tuple[int, int, int], cached: bool) -> Optional[ContextParallel]:
        """This forward's :class:`ContextParallel`, None without a cp group.
        A full forward shards latent T (``divisible_cp``); a cached forward
        shards the block's tokens, which may be rows of one frame."""
        if self.cp_group is None:
            return None
        c, r = comm.group_size(self.cp_group), comm.group_rank(self.cp_group)
        if not cached and not divisible_cp(grid[0], c):
            raise ValueError(f"context parallelism shards latent T: {grid[0]} latent frames (after the temporal "
                             f"patch) do not split over cp={c}")
        return ContextParallel(self.cp_group, self.cfg.cp_strategy, token_slab(grid, c, r))

    def _add_action(self, emb: torch.Tensor, adaln_lora: Optional[torch.Tensor], action: Optional[torch.Tensor]):
        """The action embeddings added to the timestep embedding (B, T, D)
        and the AdaLN-LoRA term: one for the chunk, (B, T_act, d) -> (B, 1,
        T_act d), or per latent frame, groups of num_action_per_latent_frame
        with frame 0 zero-padded when the groups cover all but frame 0."""
        cfg = self.cfg
        if action is None:
            raise ValueError("config.action_dim set but no action passed")
        B = action.shape[0]
        if cfg.action_per_latent_frame:
            t_act = action.shape[1] // cfg.num_action_per_latent_frame
            act = action.reshape(B, t_act, -1)
        else:
            act = action.reshape(B, 1, -1)
        act_emb, act_emb_3d = self.action_embedder_B_D(act), self.action_embedder_B_3D(act)
        if cfg.action_per_latent_frame:
            t_emb = emb.shape[1]
            if t_act + 1 == t_emb:
                act_emb, act_emb_3d = (F.pad(a, (0, 0, 1, 0)) for a in (act_emb, act_emb_3d))
            elif t_act != t_emb:
                raise ValueError(f"per-frame actions ({t_act} groups of {cfg.num_action_per_latent_frame}) must "
                                 f"cover the {t_emb} timestep frames exactly or all but frame 0")
        emb = emb + act_emb
        if adaln_lora is not None:
            adaln_lora = adaln_lora + act_emb_3d
        return emb, adaln_lora


def set_context_parallel(net: MiniTrainDIT, group) -> MiniTrainDIT:
    """Run ``net``'s forwards context-parallel over the process group
    ``group`` (a mesh's ``mesh.get_group("cp")``), or locally with None.
    Every rank of the group calls the net with the same inputs; a cached
    forward needs head-sharded caches (models/interactive.py).

    Training: the exit all-gather is differentiable, and its backward sums
    the cp ranks' output gradients into each slab. When every rank of the
    group takes the same loss over the whole output, each rank's parameter
    gradient is cp times its slab's share; parallel/mesh.py::parallelize
    folds cp into FSDP2's data-parallel mean, which divides that factor
    out and sums the slabs (tests/test_torch_mesh.py holds it against one
    device)."""
    net.cp_group = group
    return net


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
        for attn in (block.self_attn, block.cross_attn, getattr(block, "cross_view_attn", None)):
            if attn is not None:
                layers += [attn.q_proj, attn.k_proj, attn.v_proj, attn.output_proj]
        layers += [block.mlp.layer1, block.mlp.layer2]
        if net.cfg.camera_dim is not None:
            layers.append(block.cam_encoder)
    for layer in layers:
        layer.weight.data = layer.weight.data.to(dtype)
    return net


@torch.no_grad()
def init_dit_weights(net: MiniTrainDIT, generator: torch.Generator) -> MiniTrainDIT:
    """Seeded random weights: every Linear weight ~ truncated normal with
    std 1/sqrt(fan_in) (cut at 3 std), biases 0, norm weights 1, the view
    embeddings ~ normal(0, 1), the cross-view LayerNorm's scale 1 and bias
    0. The generator must live on the parameters' device."""
    for name, p in net.named_parameters():
        if name.endswith("ln_cross_view_scale"):
            p.fill_(1.0)
        elif name.endswith("ln_cross_view_bias"):
            p.zero_()
    if net.view_embedding_channels:
        net.view_embeddings.weight.normal_(generator=generator)
    for module in net.modules():
        if isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features)
            # drawn in fp32 and rounded once, so a weight stored in bf16
            # holds the fp32 draw's rounding (cast_matmul_weights' values)
            w = module.weight if module.weight.dtype == torch.float32 else torch.empty_like(module.weight, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -3 * std, 3 * std, generator=generator)
            if w is not module.weight:
                module.weight.copy_(w)
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


def build_serving_dit(cfg: DiTConfig, device: torch.device | str, seed: Optional[int] = 0) -> MiniTrainDIT:
    """A frozen MiniTrainDIT for serving, its matmul weights stored in
    ``cfg.dtype`` (:func:`cast_matmul_weights`) from the start, so the
    fp32 copy of the whole net never exists on ``device`` (the 14B net is
    about 28 GB so, 57 GB in fp32). ``seed`` gives the seeded random
    weights of :func:`build_dit` rounded as ``cast_matmul_weights`` rounds
    them; ``None`` leaves them unset, for a checkpoint to fill."""
    with torch.device("meta"):
        net = cast_matmul_weights(MiniTrainDIT(cfg))
    net = net.to_empty(device=device)
    if seed is not None:
        init_dit_weights(net, torch.Generator(device=device).manual_seed(seed))
    return net.eval().requires_grad_(False)
