"""The plain reference of the serving cells: the Cosmos DiT, its conditioning
and the UniPC sampler in float32 PyTorch, written from the configuration
file alone.

It imports nothing of the program and takes nothing the program made: the
weights come from port_bench/weights.py (the same seed, the same values),
and it works out again the RoPE table, the timestep embedding, the text
projection, the neighbourhood windows of the sparse blocks, the FRAME_REPLACE
masks, classifier-free guidance and the sampler's schedule and coefficients.

The model (the upstream MiniTrainDIT; every equation below is the
published one, with TF32 off):

* patch embed: (B, C, T, H, W) -> (B, T/pt, H/ps, W/ps, C pt ps ps) -> Linear;
  C adds a zero padding-mask channel;
* timesteps: sinusoid [cos, sin] of t -> ``emb`` = RMSNorm(sinusoid) and the
  AdaLN-LoRA term Linear(SiLU(Linear(sinusoid)));
* caption: GELU(Linear(text)) from 100,352 to 1,024 channels;
* each block: x += gate * f(LayerNorm(x) (1 + scale) + shift) for
  self-attention (per-head RMSNorm on q and k, 3D RoPE, softmax(q k^T /
  sqrt(d)) v, dense or a neighbourhood window), cross-attention over the
  caption, and a GELU MLP; (shift, scale, gate) per latent frame from
  Linear(Linear(SiLU(emb))) + the LoRA term;
* final layer: AdaLN with two chunks, Linear, unpatchify.

``Precision`` makes the same code the control: with ``fp8`` every product
takes operands rounded to float8 e4m3 with one scale per tensor (the step a
later change might take), and the activations the program keeps in bf16
(the patch embedding, each block's output, the DiT's output) are kept in
float8 e4m3 too; the rest stays float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench import weights as W


class _Float8(torch.autograd.Function):
    """Rounding to float8 e4m3 with one scale per tensor (its largest
    magnitude to 448); the gradient passes through unrounded, as a float8
    trainer's scaled gradients would."""

    @staticmethod
    def forward(ctx, t):
        scale = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class Precision:
    """float32 products (the reference) or float8 e4m3 operands (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def round(self, t: torch.Tensor) -> torch.Tensor:
        return _Float8.apply(t) if self.fp8 else t

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        y = self.round(x) @ self.round(w).T
        return y if b is None else y + b

    def attend(self, q, k, v, mask=None, chunk: int = 2048) -> torch.Tensor:
        """q (Sq, h, d), k / v (Skv, h, d) -> (Sq, h, d); ``mask`` None, or a
        function of (first, end) giving those query rows' (rows, Skv) bool
        visibility. By chunks of at most ``chunk`` query rows and 2^31
        logits, each recomputed in a backward, so that the logits of 31,104
        keys (training) or of every row of 84,480 (a whole serving block)
        fit."""
        chunk = max(1, min(chunk, (1 << 31) // (k.shape[0] * k.shape[1])))
        if q.shape[0] <= chunk:
            return self._attend(q, k, v, None if mask is None else mask(0, q.shape[0]))
        outs = []
        for c in range(0, q.shape[0], chunk):
            m = None if mask is None else mask(c, min(c + chunk, q.shape[0]))
            outs.append(checkpoint(self._attend, q[c:c + chunk], k, v, m, use_reentrant=False))
        return torch.cat(outs)

    def _attend(self, q, k, v, mask) -> torch.Tensor:
        logits = torch.einsum("qhd,khd->hqk", self.round(q), self.round(k)) / math.sqrt(q.shape[-1])
        if mask is not None:
            logits = logits.masked_fill(~mask[None], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("hqk,khd->qhd", self.round(probs), self.round(v))


def rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + eps)


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 distance of ``a`` from ``ref``, in float64."""
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp_min(1e-300))


# ------------------------------- geometry -------------------------------


def token_grid(cfg: dict, latent_thw: tuple[int, int, int]) -> tuple[int, int, int]:
    t, h, w = latent_thw
    return t // cfg["patch_temporal"], h // cfg["patch_spatial"], w // cfg["patch_spatial"]


def rope_angles(cfg: dict, grid: tuple[int, int, int], device) -> torch.Tensor:
    """(T H W, head_dim) angles: bands t, h, w of sizes d - 2 (d//6*2), d//6*2,
    d//6*2, frequencies 1 / theta^(2i / band) with theta = 1e4 ratio^(band /
    (band - 2)), positions 0.., the half table repeated (NeoX rotation). No
    fps scaling: the configurations turn it off."""
    if cfg["rope_enable_fps_modulation"]:
        raise NotImplementedError("fps-modulated RoPE: no cell of this benchmark runs it")
    d = cfg["head_dim"]
    dh = d // 6 * 2
    dt = d - 2 * dh
    bands = []
    for n, band, ratio in ((grid[0], dt, cfg["rope_t_extrapolation_ratio"]),
                           (grid[1], dh, cfg["rope_h_extrapolation_ratio"]),
                           (grid[2], dh, cfg["rope_w_extrapolation_ratio"])):
        theta = 10000.0 * ratio ** (band / (band - 2))
        freqs = 1.0 / theta ** (np.arange(0, band, 2, dtype=np.float64)[: band // 2] / band)
        bands.append(torch.outer(torch.arange(n, dtype=torch.float64), torch.from_numpy(freqs)))
    T, H, Wd = grid
    half = torch.cat([bands[0][:, None, None].expand(T, H, Wd, -1), bands[1][None, :, None].expand(T, H, Wd, -1),
                      bands[2][None, None, :].expand(T, H, Wd, -1)], dim=-1)
    return torch.cat([half, half], dim=-1).reshape(T * H * Wd, d).float().to(device)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (S, h, d) rotated by angles (S, d): x cos + rotate_half(x) sin."""
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * angles.cos()[:, None] + rotated * angles.sin()[:, None]


def dense_blocks(cfg: dict) -> set[int]:
    """The upstream rule for ``n_dense_blocks`` dense blocks among the
    sparse ones: -1 all dense, 0 none, 1 the middle one, else evenly spread."""
    n, k = cfg["num_blocks"], cfg["n_dense_blocks"]
    if k == -1:
        return set(range(n))
    if k == 0:
        return set()
    if k == 1:
        return {n // 2}
    return set(np.linspace(0, n - 1, k, dtype=int).tolist())


def na_window(cfg: dict, grid: tuple[int, int, int]) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The sparse blocks' (window, stride) at this token grid, scaled from the
    grid they were tuned on (``natten_base_size``); a window <= 1 is the
    whole axis."""
    window = [w if w > 1 else n for n, w in zip(grid, cfg["natten_window"])]
    stride = list(cfg["natten_stride"])
    base = [b if b > 0 else n for n, b in zip(grid, cfg["natten_base_size"])]
    scale = [n / b for n, b in zip(grid, base)]
    window = [min(max(2, round(w * s)), n) for w, s, n in zip(window, scale, grid)]
    stride = [min(max(1, round(st * s)), w) for w, s, st in zip(window, scale, stride)]
    return tuple(window), tuple(stride)


def na_visible(rows: torch.Tensor, grid, window, stride) -> torch.Tensor:
    """(len(rows), T H W) bool: key j in query i's neighbourhood. Per axis of
    length L the query's group (stride s) takes its centre's window of w
    positions, clamped inside the axis: keys c - (w-1)//2 .. c + w//2 with c
    = clamp(s (i // s) + (s-1)//2, (w-1)//2, L-1-w//2)."""
    T, H, Wd = grid
    cols = torch.arange(T * H * Wd, device=rows.device)
    mask = torch.ones((rows.numel(), cols.numel()), dtype=torch.bool, device=rows.device)
    for div, L, w, s in ((H * Wd, T, window[0], stride[0]), (Wd, H, window[1], stride[1]), (1, Wd, window[2], stride[2])):
        if w >= L:
            continue
        qi, kj = (rows // div) % L, (cols // div) % L
        lo, hi = (w - 1) // 2, w - 1 - (w - 1) // 2
        centre = torch.clamp((qi // s) * s + (s - 1) // 2, lo, L - 1 - hi)
        mask &= (kj[None] >= (centre - lo)[:, None]) & (kj[None] <= (centre + hi)[:, None])
    return mask


# --------------------------------- the DiT ---------------------------------


class DiT:
    """The plain DiT over fp32 weights (name -> tensor, the checkpoint names)."""

    def __init__(self, cfg: dict, params: dict[str, torch.Tensor], precision: Precision | None = None):
        self.cfg, self.p = cfg, params
        self.prec = precision or Precision()
        self.dense = dense_blocks(cfg)

    @staticmethod
    def make_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
        return DiT.make_params_from(W.dit_spec(cfg), seed, device)

    @staticmethod
    def make_params_from(spec, seed: int, device) -> dict[str, torch.Tensor]:
        """fp32 tensors holding the seed's values of ``spec``'s parameters."""
        params = {name: torch.empty(shape, dtype=torch.float32, device=device) for name, shape, _ in spec}
        W.fill(spec, params, seed)
        return params

    def patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, H, W) with every input channel -> (B, T', H', W', D)."""
        c = self.cfg
        B, C, T, H, Wd = x.shape
        ps, pt = c["patch_spatial"], c["patch_temporal"]
        x = x.reshape(B, C, T // pt, pt, H // ps, ps, Wd // ps, ps).permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = x.reshape(B, T // pt, H // ps, Wd // ps, C * pt * ps * ps)
        return self.prec.round(self.prec.linear(x, self.p["x_embedder.proj.1.weight"]))

    def time_embed(self, t_B_T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(emb (B, T, D), AdaLN-LoRA term (B, T, 3D)); fp32 layers."""
        d = self.cfg["model_channels"]
        half = d // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=t_B_T.device) / half)
        args = t_B_T.double()[..., None] * freqs
        sinusoid = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()
        h = F.silu(sinusoid @ self.p["t_embedder.1.linear_1.weight"].T)
        lora = h @ self.p["t_embedder.1.linear_2.weight"].T
        return rms(sinusoid, self.p["t_embedding_norm.weight"]), lora

    def caption(self, text: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.prec.linear(text, self.p["crossattn_proj.0.weight"], self.p["crossattn_proj.0.bias"]))

    def modulation(self, prefix: str, emb, lora, n: int):
        """n chunks (B, T, D) of Linear(Linear(SiLU(emb))) + the LoRA term."""
        out = F.silu(emb) @ self.p[f"{prefix}.1.weight"].T @ self.p[f"{prefix}.2.weight"].T
        out = out + lora[..., : out.shape[-1]]
        return out.chunk(n, dim=-1)

    def _attention_rows(self, pre: str, xn_all, xn_rows, rows, ctx, angles, mask):
        """One sample's attention for the query rows: xn_all (S, D) keys and
        values (self) or ctx (M, D') (cross); xn_rows (R, D)."""
        hd = self.cfg["head_dim"]
        heads = lambda t: t.reshape(t.shape[0], -1, hd)
        src = xn_all if ctx is None else ctx
        q = rms(heads(self.prec.linear(xn_rows, self.p[f"{pre}.q_proj.weight"])), self.p[f"{pre}.q_norm.weight"])
        k = rms(heads(self.prec.linear(src, self.p[f"{pre}.k_proj.weight"])), self.p[f"{pre}.k_norm.weight"])
        v = heads(self.prec.linear(src, self.p[f"{pre}.v_proj.weight"]))
        if ctx is None:
            q, k = apply_rope(q, angles[rows]), apply_rope(k, angles)
        out = self.prec.attend(q, k, v, mask)
        return self.prec.linear(out.reshape(out.shape[0], -1), self.p[f"{pre}.output_proj.weight"])

    def block_rows(self, i: int, x: torch.Tensor, rows: torch.Tensor, emb, lora, ctx, grid):
        """Block ``i`` of one sample at the token ``rows``: x (S, D) is the
        block's whole input, emb / lora (T', D) / (T', 3D), ctx (M, D') the
        projected caption. Returns the block's output at ``rows`` (R, D) and
        its self-attention's (after the output projection, before the gate)."""
        p = f"blocks.{i}"
        T, H, Wd = grid
        frame = torch.arange(x.shape[0], device=x.device) // (H * Wd)
        angles = rope_angles(self.cfg, grid, x.device)

        shift, scale, gate = self.modulation(f"{p}.adaln_modulation_self_attn", emb, lora, 3)
        xn = layer_norm(x) * (1 + scale[frame]) + shift[frame]
        window = None if i in self.dense else na_window(self.cfg, grid)
        mask = None if window is None else (lambda a, b: na_visible(rows[a:b], grid, *window))
        attn = self._attention_rows(f"{p}.self_attn", xn, xn[rows], rows, None, angles, mask)
        fr = frame[rows]
        y = x[rows] + gate[fr] * attn

        shift, scale, gate = self.modulation(f"{p}.adaln_modulation_cross_attn", emb, lora, 3)
        yn = layer_norm(y) * (1 + scale[fr]) + shift[fr]
        y = y + gate[fr] * self._attention_rows(f"{p}.cross_attn", None, yn, rows, ctx, None, None)

        shift, scale, gate = self.modulation(f"{p}.adaln_modulation_mlp", emb, lora, 3)
        yn = layer_norm(y) * (1 + scale[fr]) + shift[fr]
        h = F.gelu(self.prec.linear(yn, self.p[f"{p}.mlp.layer1.weight"]))
        return self.prec.round(y + gate[fr] * self.prec.linear(h, self.p[f"{p}.mlp.layer2.weight"])), attn

    def block_all(self, i: int, x: torch.Tensor, emb, lora, ctx, grid) -> torch.Tensor:
        """Block ``i`` of one sample at every row."""
        return self.block_rows(i, x, torch.arange(x.shape[0], device=x.device), emb, lora, ctx, grid)[0]

    def final(self, x: torch.Tensor, emb, lora, grid) -> torch.Tensor:
        """x (B, T' H' W', D) -> (B, C, T, H, W)."""
        c = self.cfg
        B = x.shape[0]
        T, H, Wd = grid
        shift, scale = self.modulation("final_layer.adaln_modulation", emb, lora, 2)
        frame = torch.arange(x.shape[1], device=x.device) // (H * Wd)
        xn = layer_norm(x) * (1 + scale[:, frame]) + shift[:, frame]
        y = self.prec.round(self.prec.linear(xn, self.p["final_layer.linear.weight"]))
        ps, pt, co = c["patch_spatial"], c["patch_temporal"], c["out_channels"]
        y = y.reshape(B, T, H, Wd, ps, ps, pt, co).permute(0, 7, 1, 6, 2, 4, 3, 5)
        return y.reshape(B, co, T * pt, H * ps, Wd * ps)

    def forward(self, x_in: torch.Tensor, t_B_T: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """The whole forward, every row (small sizes: the CPU tests)."""
        x = self.patch_embed(x_in)
        B, T, H, Wd, D = x.shape
        grid = (T, H, Wd)
        emb, lora = self.time_embed(t_B_T)
        emb, lora = emb.expand(B, T, -1), lora.expand(B, T, -1)
        ctx = self.caption(text)
        x = x.reshape(B, T * H * Wd, D)
        for i in range(self.cfg["num_blocks"]):
            x = torch.stack([self.block_all(i, x[b], emb[b], lora[b], ctx[b], grid) for b in range(B)])
        return self.final(x, emb, lora, grid)


def denoise_input(x: torch.Tensor, gt: torch.Tensor, k: int, concat_padding_mask: bool) -> torch.Tensor:
    """FRAME_REPLACE on the DiT input: the first k latent frames of x (B, C, T,
    H, W) replaced by the clean latents, and the zero padding-mask channel."""
    x = x.clone()
    x[:, :, :k] = gt[:, :, :k].expand(x.shape[0], -1, -1, -1, -1)
    if concat_padding_mask:
        x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    return x


def guided_velocity(v_pred_cond, v_pred_uncond, noise, gt, k: int, guidance: float) -> torch.Tensor:
    """FRAME_REPLACE on the velocity (the first k frames take noise - gt),
    then guidance: cond + g (cond - uncond)."""
    out = []
    for v in (v_pred_cond, v_pred_uncond):
        v = v.clone()
        v[:, :, :k] = (noise - gt)[:, :, :k]
        out.append(v)
    return out[0] + guidance * (out[0] - out[1])


# --------------------------------- UniPC ---------------------------------


def unipc_schedule(num_steps: int, shift: float, n_train: int = 1000) -> dict[str, np.ndarray]:
    """The flow-matching UniPC (bh2, predict-x0, order 2, lower order at the
    end) in float64: sigmas linspace(1 - 1/n_train, 0, N + 1)[:-1] under the
    shift map s' = k s / (1 + (k - 1) s), then 0; timesteps floor(1000 s');
    predictor and corrector weights from lambda = log((1 - s) / s)."""
    sig = np.linspace(1.0 - 1.0 / n_train, 0.0, num_steps + 1)[:-1]
    sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    timesteps = np.floor(sig * n_train)
    sig = np.concatenate([sig, [0.0]])
    n = num_steps
    order = [min(2, n - i, i + 1) for i in range(n)]

    def lam(s):
        return math.inf if s <= 0 else (-math.inf if s >= 1 else math.log(1 - s) - math.log(s))

    tab = {key: np.zeros(n) for key in ("c_ratio", "c_m0", "c_hist", "c_d1t", "p_ratio", "p_m0", "p_hist")}
    use_corr = np.zeros(n, dtype=bool)
    for i in range(n):
        if i > 0:  # corrector of x_i with the new model output, order of step i-1
            o = order[i - 1]
            h = lam(sig[i]) - lam(sig[i - 1])
            hh = -h
            phi1, B_h = math.expm1(hh), math.expm1(hh)
            a = 1 - sig[i]
            use_corr[i] = True
            tab["c_ratio"][i], tab["c_m0"][i] = sig[i] / sig[i - 1], a * phi1
            if o == 1:
                tab["c_d1t"][i] = a * B_h * 0.5
            else:
                r = (lam(sig[i - 2]) - lam(sig[i - 1])) / h
                b1 = (phi1 / hh - 1.0) / B_h
                b2 = ((phi1 / hh - 1.0) / hh - 0.5) * 2.0 / B_h
                rho = np.linalg.solve(np.array([[1.0, 1.0], [r, 1.0]]), np.array([b1, b2]))
                tab["c_hist"][i] = a * B_h * rho[0] / r
                tab["c_d1t"][i] = a * B_h * rho[1]
        o = order[i]
        h = lam(sig[i + 1]) - lam(sig[i])
        phi1 = B_h = math.expm1(-h)
        a = 1 - sig[i + 1]
        tab["p_ratio"][i], tab["p_m0"][i] = sig[i + 1] / sig[i], a * phi1
        if o == 2:
            r = (lam(sig[i - 1]) - lam(sig[i])) / h
            tab["p_hist"][i] = a * B_h * 0.5 / r
    return dict(tab, timesteps=timesteps, sigmas=sig, use_corrector=use_corr)


def unipc_states(sched: dict, x0: torch.Tensor, velocities: list[torch.Tensor], round_fn=lambda t: t) -> list:
    """The sampler's states x_1 .. x_n from x_0 and the model's velocities
    v_0 .. v_{n-1}, in float64 (``round_fn`` rounds each state: the control).
    Step i: m_i = x_i - s_i v_i; the corrector (i > 0) refines x_i from
    x_{i-1}, m_{i-1}, m_{i-2} and m_i; the predictor gives x_{i+1}."""
    x, last_x = x0.double(), None
    ms: list[torch.Tensor] = []
    out = []
    for i, v in enumerate(velocities):
        m = x - sched["sigmas"][i] * v.double()
        if sched["use_corrector"][i]:
            m0 = ms[-1]
            x = sched["c_ratio"][i] * last_x - sched["c_m0"][i] * m0 - sched["c_d1t"][i] * (m - m0)
            if len(ms) > 1:
                x = x - sched["c_hist"][i] * (ms[-2] - m0)
            x = round_fn(x)
        ms.append(m)
        nxt = sched["p_ratio"][i] * x - sched["p_m0"][i] * m
        if len(ms) > 1:
            nxt = nxt - sched["p_hist"][i] * (ms[-2] - m)
        last_x, x = x, round_fn(nxt)
        out.append(x)
    return out
