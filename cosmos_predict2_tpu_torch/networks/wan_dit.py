"""The Wan2.1 diffusion backbone (t2v and i2v) in PyTorch.

Counterpart of cosmos_predict2_tpu/networks/wan_dit.py. Submodules carry the
reference ``WanModel``'s state-dict names (``patch_embedding``,
``text_embedding.{0,2}``, ``time_embedding.{0,2}``, ``time_projection.1``,
``blocks.{i}.self_attn.{q,k,v,o,norm_q,norm_k}``, ``blocks.{i}.norm3``,
``blocks.{i}.ffn.{0,2}``, ``blocks.{i}.modulation``, ``head.head``,
``head.modulation``, ``img_emb.proj.{0,1,3,4}``), so a released state dict
loads through utils/checkpoint_convert.py::convert_wan_dit_state_dict.

Where Wan differs from the Cosmos DiT (networks/dit.py), and what a port can
get silently wrong:

* the patch embedding is a Linear over (kt, kh, kw) patches, its rows (C,
  kt, kh, kw)-major, with the padding-mask channel last;
* the timestep sinusoid is cos-first (the reference computes it in fp64,
  the JAX package in fp32; the port follows the JAX package);
* RoPE rotates INTERLEAVED pairs (2i, 2i + 1) with [t | h | w] half-dim
  frequency bands (:func:`wan_rope_freqs`), not the DiT's halves;
* q/k RMSNorm runs over the full width, not per head;
* the block LayerNorms are affine-free, except the cross-attention's
  ``norm3``; modulation is fp32: each block's learned (1, 6, dim) table
  plus ``time_projection``'s six vectors, and the head's own (1, 2, dim)
  table plus the time embedding;
* the text projection is Linear -> GELU (tanh) -> Linear; i2v adds the
  CLIP branch: the context's first ``len - 512`` tokens are image tokens
  (257 for CLIP ViT-H), projected by ``img_emb`` and attended by their own
  ``k_img`` / ``v_img`` in each cross-attention, whose output is added.

Every attention (self over the video tokens, cross over the 512 text
tokens, cross over the 257 image tokens) goes through
ops/attention.py::dot_product_attention: K1 on a CUDA tensor (bf16, head dim
128; the kernel masks the ragged 257-key tail), its plain version on the
CPU. The JAX package computes both cross-attentions with its fp32
reference (materialised logits); the port does not.

Tensor parallelism (parallel/mesh.py::parallelize): q / k / v / k_img /
v_img and ``ffn.0`` are column parallel, ``o`` and ``ffn.2`` row parallel,
so each rank runs RoPE and K1 on its own heads (the head count is read
from the projections' local width); the whole-width q / k norms sum their
squares over tp (parallel/mesh.py::tp_rms_norm).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cosmos_predict2_tpu_torch.networks.dit import linear
from cosmos_predict2_tpu_torch.ops.attention import dot_product_attention
from cosmos_predict2_tpu_torch.ops.normalization import layer_norm, rms_norm
from cosmos_predict2_tpu_torch.parallel.mesh import DTensor, tp_rms_norm

T5_CONTEXT_TOKEN_NUMBER = 512
CLIP_TOKENS = 257


@dataclasses.dataclass(frozen=True)
class WanConfig:
    model_type: str = "i2v"  # "t2v" | "i2v" | "flf2v"
    patch_size: tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 36  # 16 latent + 20 conditional (i2v)
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    text_dim: int = 4096  # umT5-xxl
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    concat_padding_mask: bool = True
    clip_dim: int = 1280
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def i2v(self) -> bool:
        return self.model_type in ("i2v", "flf2v")


WAN_PRESETS = {
    "1.3B": WanConfig(),
    "14B": WanConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40),
    "test": WanConfig(dim=96, ffn_dim=192, num_heads=2, num_layers=2, dtype=torch.float32),
}


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, dim) fp32, [cos | sin]."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=position.device) / half)
    sinusoid = position.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def _band(dim: int, ratio: float) -> np.ndarray:
    theta = 10000.0 * ratio ** (dim / (dim - 2))
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))


def wan_rope_freqs(head_dim: int, T: int, H: int, W: int, device, ratios=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Half-dim angle table (T*H*W, head_dim // 2) fp32: [t | h | w] bands,
    dim_h = dim_w = head_dim // 6 * 2 and dim_t the rest; no fps modulation.
    ``ratios``: the (t, h, w) extrapolation ratios."""
    dim_h = head_dim // 6 * 2
    dim_t = head_dim - 2 * dim_h
    rt, rh, rw = ratios
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    ft = torch.arange(T, dtype=torch.float32, device=device)[:, None] * f(_band(dim_t, rt))[None]
    fh = torch.arange(H, dtype=torch.float32, device=device)[:, None] * f(_band(dim_h, rh))[None]
    fw = torch.arange(W, dtype=torch.float32, device=device)[:, None] * f(_band(dim_h, rw))[None]
    full = torch.cat([
        ft[:, None, None, :].expand(T, H, W, -1),
        fh[None, :, None, :].expand(T, H, W, -1),
        fw[None, None, :, :].expand(T, H, W, -1),
    ], dim=-1)
    return full.reshape(T * H * W, -1)


def rope_apply_interleaved(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D): pairs (2i, 2i + 1) rotate by freqs[:, i], in fp32,
    the result in x's dtype."""
    B, S, H, D = x.shape
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    xf = x.float().reshape(B, S, H, D // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(B, S, H, D).to(x.dtype)


class WanRMSNorm(nn.Module):
    """RMSNorm over the full width (eps from the config), fp32 inside; over
    a width sharded by tensor parallelism, through tp_rms_norm."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.weight, DTensor):
            return tp_rms_norm(x, self.weight, self.eps)
        return rms_norm(x, self.weight, self.eps)


def _affine_layer_norm(norm: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """layer_norm(x) * weight + bias, as the JAX package writes it (the
    product promotes a bf16 x to fp32)."""
    return layer_norm(x, eps) * norm.weight + norm.bias


def _heads(t: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, S, h * head_dim) -> (B, S, h, head_dim): every head, or under
    tensor parallelism this rank's."""
    return t.reshape(t.shape[0], t.shape[1], -1, head_dim)


class WanSelfAttention(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.q, self.k, self.v, self.o = (nn.Linear(d, d) for _ in range(4))
        if cfg.qk_norm:
            self.norm_q = WanRMSNorm(d, cfg.eps)
            self.norm_k = WanRMSNorm(d, cfg.eps)

    def forward(self, x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        q, k, v = linear(self.q, x, dt), linear(self.k, x, dt), linear(self.v, x, dt)
        if cfg.qk_norm:
            q, k = self.norm_q(q), self.norm_k(k)
        q = rope_apply_interleaved(_heads(q, cfg.head_dim), freqs).contiguous()
        k = rope_apply_interleaved(_heads(k, cfg.head_dim), freqs).contiguous()
        out = dot_product_attention(q, k, _heads(v, cfg.head_dim).contiguous())
        return linear(self.o, out.reshape(x.shape[0], x.shape[1], -1), dt)


class WanCrossAttention(nn.Module):
    """Cross-attention to the text tokens and, for i2v, to the image tokens
    in front of them (a second attention whose output is added)."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.q, self.k, self.v, self.o = (nn.Linear(d, d) for _ in range(4))
        if cfg.qk_norm:
            self.norm_q = WanRMSNorm(d, cfg.eps)
            self.norm_k = WanRMSNorm(d, cfg.eps)
        if cfg.i2v:
            self.k_img = nn.Linear(d, d)
            self.v_img = nn.Linear(d, d)
            if cfg.qk_norm:
                self.norm_k_img = WanRMSNorm(d, cfg.eps)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cfg, dt, d = self.cfg, self.cfg.dtype, self.cfg.head_dim
        if cfg.i2v:
            img_len = context.shape[1] - T5_CONTEXT_TOKEN_NUMBER
            context_img, context = context[:, :img_len], context[:, img_len:]
        q, k, v = linear(self.q, x, dt), linear(self.k, context, dt), linear(self.v, context, dt)
        if cfg.qk_norm:
            q, k = self.norm_q(q), self.norm_k(k)
        q = _heads(q, d).contiguous()
        out = dot_product_attention(q, _heads(k, d).contiguous(), _heads(v, d).contiguous())
        if cfg.i2v:
            k_img, v_img = linear(self.k_img, context_img, dt), linear(self.v_img, context_img, dt)
            if cfg.qk_norm:
                k_img = self.norm_k_img(k_img)
            out = out + dot_product_attention(q, _heads(k_img, d).contiguous(), _heads(v_img, d).contiguous())
        return linear(self.o, out.reshape(x.shape[0], x.shape[1], -1), dt)


class WanAttentionBlock(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = WanSelfAttention(cfg)
        self.cross_attn = WanCrossAttention(cfg)
        if cfg.cross_attn_norm:
            self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps)
        self.ffn = nn.Sequential(nn.Linear(cfg.dim, cfg.ffn_dim), nn.GELU(approximate="tanh"),
                                 nn.Linear(cfg.ffn_dim, cfg.dim))
        self.modulation = nn.Parameter(torch.zeros(1, 6, cfg.dim))

    def forward(self, x, e0_B_6_D, freqs, context):
        cfg, dt = self.cfg, self.cfg.dtype
        e = (self.modulation.float() + e0_B_6_D.float()).unbind(1)
        e = [c[:, None, :] for c in e]  # each (B, 1, D)

        y = layer_norm(x, cfg.eps).float() * (1 + e[1]) + e[0]
        y = self.self_attn(y.to(dt), freqs)
        x = (x.float() + y.float() * e[2]).to(x.dtype)

        normed = _affine_layer_norm(self.norm3, x, cfg.eps) if cfg.cross_attn_norm else x
        x = x + self.cross_attn(normed.to(dt), context).to(x.dtype)

        y = layer_norm(x, cfg.eps).float() * (1 + e[4]) + e[3]
        h = F.gelu(linear(self.ffn[0], y.to(dt), dt), approximate="tanh")
        y = linear(self.ffn[2], h, dt)
        return (x.float() + y.float() * e[5]).to(x.dtype)


class Head(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.head = nn.Linear(cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim)
        self.modulation = nn.Parameter(torch.zeros(1, 2, cfg.dim))


class MLPProj(nn.Module):
    """The CLIP image tokens' projection: LayerNorm -> Linear -> GELU ->
    Linear -> LayerNorm (eps 1e-5)."""

    def __init__(self, clip_dim: int, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.LayerNorm(clip_dim, eps=1e-5), nn.Linear(clip_dim, clip_dim), nn.GELU(),
                                  nn.Linear(clip_dim, dim), nn.LayerNorm(dim, eps=1e-5))

    def forward(self, img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ln0, fc1, _, fc3, ln4 = self.proj
        h = _affine_layer_norm(ln0, img.float(), 1e-5)
        h = F.gelu(linear(fc1, h, dtype))
        h = linear(fc3, h, dtype)
        return _affine_layer_norm(ln4, h.float(), 1e-5)


class WanModel(nn.Module):
    """x (B, C, T, H, W), timesteps (B,) or (B, T) (the first column is
    taken), crossattn_emb (B, 512, text_dim); i2v: y (B, in_dim - C, T, H,
    W) and the CLIP tokens (B, 257, clip_dim) (zeros when None). Returns
    (B, out_dim, T, H, W) fp32."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        in_ch = cfg.in_dim + int(cfg.concat_padding_mask)
        self.patch_embedding = nn.Linear(in_ch * math.prod(cfg.patch_size), d)
        self.text_embedding = nn.Sequential(nn.Linear(cfg.text_dim, d), nn.GELU(approximate="tanh"), nn.Linear(d, d))
        self.time_embedding = nn.Sequential(nn.Linear(cfg.freq_dim, d), nn.SiLU(), nn.Linear(d, d))
        self.time_projection = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d))
        self.blocks = nn.ModuleList(WanAttentionBlock(cfg) for _ in range(cfg.num_layers))
        self.head = Head(cfg)
        if cfg.i2v:
            self.img_emb = MLPProj(cfg.clip_dim, d)

    def forward(
        self,
        x_B_C_T_H_W: torch.Tensor,
        timesteps_B_T: torch.Tensor,
        crossattn_emb: torch.Tensor,
        y_B_C_T_H_W: Optional[torch.Tensor] = None,
        frame_cond_crossattn_emb: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        if timesteps_B_T.ndim == 2:
            timesteps_B_T = timesteps_B_T[:, 0]
        if y_B_C_T_H_W is not None:
            x_B_C_T_H_W = torch.cat([x_B_C_T_H_W, y_B_C_T_H_W.to(x_B_C_T_H_W.dtype)], dim=1)
        B, C, T, H, W = x_B_C_T_H_W.shape
        if cfg.concat_padding_mask:
            if padding_mask is None:
                padding_mask = x_B_C_T_H_W.new_zeros((B, 1, H, W))
            mask = padding_mask[:, :1, None].expand(B, 1, T, H, W).to(x_B_C_T_H_W.dtype)
            x_B_C_T_H_W = torch.cat([x_B_C_T_H_W, mask], dim=1)
            C += 1

        kt, kh, kw = cfg.patch_size
        Tt, Hp, Wp = T // kt, H // kh, W // kw
        x = x_B_C_T_H_W.reshape(B, C, Tt, kt, Hp, kh, Wp, kw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = linear(self.patch_embedding, x.reshape(B, Tt * Hp * Wp, C * kt * kh * kw), dt)

        # time path, fp32
        e = sinusoidal_embedding_1d(cfg.freq_dim, timesteps_B_T)
        e = F.silu(linear(self.time_embedding[0], e, torch.float32))
        e_B_D = linear(self.time_embedding[2], e, torch.float32)
        e0_B_6_D = linear(self.time_projection[1], F.silu(e_B_D), torch.float32).reshape(B, 6, cfg.dim)

        ctx = F.gelu(linear(self.text_embedding[0], crossattn_emb, dt), approximate="tanh")
        ctx = linear(self.text_embedding[2], ctx, dt)
        if cfg.i2v:
            if frame_cond_crossattn_emb is None:
                frame_cond_crossattn_emb = torch.zeros((B, CLIP_TOKENS, cfg.clip_dim), dtype=dt, device=x.device)
            ctx = torch.cat([self.img_emb(frame_cond_crossattn_emb, dt).to(dt), ctx], dim=1)

        freqs = wan_rope_freqs(cfg.head_dim, Tt, Hp, Wp, x.device)
        for block in self.blocks:
            x = block(x, e0_B_6_D, freqs, ctx)

        eh = self.head.modulation.float() + e_B_D[:, None, :]  # (B, 2, D)
        y = layer_norm(x, cfg.eps).float() * (1 + eh[:, 1:2]) + eh[:, 0:1]
        x = linear(self.head.head, y, torch.float32)
        # b (t h w) (kt kh kw d) -> b d (t kt) (h kh) (w kw)
        x = x.reshape(B, Tt, Hp, Wp, kt, kh, kw, cfg.out_dim).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(B, cfg.out_dim, Tt * kt, Hp * kh, Wp * kw)


def matmul_linears(net: WanModel) -> list[nn.Linear]:
    """The Linears the net multiplies in ``cfg.dtype``: patch embedding, text
    projection, the blocks' attention and FFN projections, the image
    projection's two. The time path and the head compute in fp32."""
    layers = [net.patch_embedding, net.text_embedding[0], net.text_embedding[2]]
    if net.cfg.i2v:
        layers += [net.img_emb.proj[1], net.img_emb.proj[3]]
    for block in net.blocks:
        for attn in (block.self_attn, block.cross_attn):
            layers += [m for m in attn.children() if isinstance(m, nn.Linear)]
        layers += [block.ffn[0], block.ffn[2]]
    return layers


@torch.no_grad()
def init_wan_weights(net: WanModel, generator: torch.Generator) -> WanModel:
    """Seeded random weights: Linear weights ~ truncated normal with std
    1/sqrt(fan_in), biases 0, norm weights 1 and LayerNorm biases 0, the
    modulation tables ~ normal(0, 1/sqrt(dim)) (the reference's init). The
    generator must live on the parameters' device."""
    for module in net.modules():
        if isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features)
            w = module.weight if module.weight.dtype == torch.float32 else torch.empty_like(module.weight, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -3 * std, 3 * std, generator=generator)
            if w is not module.weight:
                module.weight.copy_(w)
            module.bias.zero_()
        elif isinstance(module, (WanRMSNorm, nn.LayerNorm)):
            module.weight.fill_(1.0)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
    for name, p in net.named_parameters():
        if name.endswith("modulation"):
            p.normal_(0.0, 1.0 / math.sqrt(net.cfg.dim), generator=generator)
    return net


def build_wan(cfg: WanConfig, device: torch.device | str, seed: Optional[int] = 0) -> WanModel:
    """A frozen WanModel for serving, made on ``device``: the Linears of
    :func:`matmul_linears` stored in ``cfg.dtype`` (their bias too), the
    rest fp32. ``seed`` gives seeded random weights (:func:`init_wan_weights`,
    drawn in fp32 and rounded once); ``None`` leaves them unset, for a
    checkpoint to fill."""
    with torch.device("meta"):
        net = WanModel(cfg)
        for layer in matmul_linears(net):
            layer.weight.data = layer.weight.data.to(cfg.dtype)
            layer.bias.data = layer.bias.data.to(cfg.dtype)
    net = net.to_empty(device=device)
    if seed is not None:
        init_wan_weights(net, torch.Generator(device=device).manual_seed(seed))
    return net.eval().requires_grad_(False)
