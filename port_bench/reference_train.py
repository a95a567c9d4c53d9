"""The plain reference of the post-training cell, in float32 PyTorch: the
Wan2.1 VAE encoder, the rectified-flow training loss of the DiT with its
backward, gradient clipping, AdamW with the LambdaLinear schedule and the
power EMA. Written from the configuration and traffic files; it imports
nothing of the program and takes nothing the program made (its weights from
port_bench/weights.py, the draws from the benchmark).

The encoder (Wan2.1, 8x spatial and 4x temporal compression) runs causally
in chunks, frame 0 alone and then 4 frames at a time, each causal 3x3x3
conv carrying its last 2 input frames (zeros at the start) and each
stride-2 temporal conv its last frame, frame 0 bypassing it: the same
function as the whole clip at once, in O(chunk) memory. RMS_norm is the L2
normalisation over channels times sqrt(C) gamma; the middle holds one
single-head per-frame attention; the latents are the first 16 of 32
channels, normalised by the published per-channel mean and std.

The loss (one sample): x_t = eps s + x0 (1 - s), target eps - x0, the first
k latent frames of the input replaced by x0 (times the video-condition
flag) and of the prediction by eps - x0, the text zeroed when dropped;
loss = loss_scale mean((v - target)^2). The DiT is port_bench/reference.py's,
every row, each block and each attention chunk recomputed in the backward
(torch.utils.checkpoint) so that 31,104 tokens fit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench import reference as R
from port_bench import weights as W

# the Wan2.1 VAE's published per-channel latent statistics
LATENT_MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
               0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
LATENT_STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
              3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


# --------------------------------- the VAE ---------------------------------


def vae_layers(v: dict) -> list[tuple]:
    """The encoder's layers in order: ("res", prefix, cin, cout) and
    ("down", prefix, dim, temporal)."""
    dims = [v["dim"] * m for m in (1, *v["dim_mult"])]
    layers, li = [], 0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(v["num_res_blocks"]):
            layers.append(("res", f"encoder.downsamples.{li}", cin, cout))
            cin, li = cout, li + 1
        if i != len(v["dim_mult"]) - 1:
            layers.append(("down", f"encoder.downsamples.{li}", cout, v["temporal_downsample"][i]))
            li += 1
    return layers


def vae_encoder_spec(v: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """The encoder's parameters by the checkpoint's names (conv weights bf16
    values, N(0, 1/fan_in); biases 0; norm gammas 1)."""
    spec = []

    def conv(name, cout, cin, *k):
        spec.extend([(f"{name}.weight", (cout, cin, *k), "matmul"), (f"{name}.bias", (cout,), "zeros")])

    def res(p, cin, cout):
        spec.append((f"{p}.residual.0.gamma", (cin, 1, 1, 1), "ones"))
        conv(f"{p}.residual.2", cout, cin, 3, 3, 3)
        spec.append((f"{p}.residual.3.gamma", (cout, 1, 1, 1), "ones"))
        conv(f"{p}.residual.6", cout, cout, 3, 3, 3)
        if cin != cout:
            conv(f"{p}.shortcut", cout, cin, 1, 1, 1)

    top = v["dim"] * v["dim_mult"][-1]
    conv("encoder.conv1", v["dim"], 3, 3, 3, 3)
    for kind, p, a, b in vae_layers(v):
        if kind == "res":
            res(p, a, b)
        else:
            conv(f"{p}.resample.1", a, a, 3, 3)
            if b:
                conv(f"{p}.time_conv", a, a, 3, 1, 1)
    res("encoder.middle.0", top, top)
    spec.append(("encoder.middle.1.norm.gamma", (top, 1, 1), "ones"))
    conv("encoder.middle.1.to_qkv", 3 * top, top, 1, 1)
    conv("encoder.middle.1.proj", top, top, 1, 1)
    res("encoder.middle.2", top, top)
    spec.append(("encoder.head.0.gamma", (top, 1, 1, 1), "ones"))
    conv("encoder.head.2", 2 * v["z_dim"], top, 3, 3, 3)
    conv("conv1", 2 * v["z_dim"], 2 * v["z_dim"], 1, 1, 1)
    return spec


def _norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """x (C, T, H, W): L2 over channels, times sqrt(C) gamma."""
    return x / x.norm(dim=0, keepdim=True).clamp_min(1e-12) * math.sqrt(x.shape[0]) * gamma.reshape(-1, 1, 1, 1)


class VAEEncoder:
    """The causal encoder over one clip, chunk by chunk; with a float8
    ``precision`` (the control) every conv's input and weight and each
    chunk's latents are rounded to float8 e4m3."""

    def __init__(self, v: dict, params: dict[str, torch.Tensor], precision=None):
        self.v, self.p = v, params
        self.prec = precision or R.Precision()
        r = self.prec.round
        self.conv3d = lambda x, w, b, **kw: F.conv3d(r(x), r(w), b, **kw)
        self.conv2d = lambda x, w, b, **kw: F.conv2d(r(x), r(w), b, **kw)

    def _cconv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Causal 3x3x3 conv of x (C, t, H, W) after the cached 2 frames."""
        xin = torch.cat([self.cache.get(name, torch.zeros_like(x[:, :1]).expand(-1, 2, -1, -1)), x], dim=1)
        self.cache[name] = xin[:, -2:]
        return self.conv3d(xin[None], self.p[f"{name}.weight"], self.p[f"{name}.bias"], padding=(0, 1, 1))[0]

    def _res(self, p: str, x: torch.Tensor) -> torch.Tensor:
        h = x
        if f"{p}.shortcut.weight" in self.p:
            h = self.conv3d(x[None], self.p[f"{p}.shortcut.weight"], self.p[f"{p}.shortcut.bias"])[0]
        y = self._cconv(f"{p}.residual.2", F.silu(_norm(x, self.p[f"{p}.residual.0.gamma"])))
        y = self._cconv(f"{p}.residual.6", F.silu(_norm(y, self.p[f"{p}.residual.3.gamma"])))
        return y + h

    def _attention(self, p: str, x: torch.Tensor) -> torch.Tensor:
        C, T, H, Wd = x.shape
        y = _norm(x, self.p[f"{p}.norm.gamma"])
        qkv = torch.einsum("oc,cthw->tohw", self.p[f"{p}.to_qkv.weight"][:, :, 0, 0], y)
        qkv = qkv + self.p[f"{p}.to_qkv.bias"][None, :, None, None]
        q, k, vv = qkv.reshape(T, 3, C, H * Wd).unbind(1)
        probs = torch.softmax(torch.einsum("tcq,tck->tqk", q, k) / math.sqrt(C), dim=-1)
        out = torch.einsum("tqk,tck->tcq", probs, vv)
        out = torch.einsum("oc,tcq->otq", self.p[f"{p}.proj.weight"][:, :, 0, 0], out)
        return x + (out + self.p[f"{p}.proj.bias"][:, None, None]).reshape(C, T, H, Wd)

    def _chunk(self, x: torch.Tensor, first: bool) -> torch.Tensor:
        x = self._cconv("encoder.conv1", x)
        for kind, p, _, temporal in vae_layers(self.v):
            if kind == "res":
                x = self._res(p, x)
                continue
            x = self.conv2d(F.pad(x.transpose(0, 1), (0, 1, 0, 1)), self.p[f"{p}.resample.1.weight"],
                         self.p[f"{p}.resample.1.bias"], stride=2).transpose(0, 1)
            if temporal:
                w, b = self.p[f"{p}.time_conv.weight"], self.p[f"{p}.time_conv.bias"]
                if first:
                    self.cache[p] = x[:, -1:]
                    if x.shape[1] > 1:
                        x = torch.cat([x[:, :1], self.conv3d(x[None], w, b, stride=(2, 1, 1))[0]], dim=1)
                else:
                    xin = torch.cat([self.cache[p], x], dim=1)
                    self.cache[p] = xin[:, -1:]
                    x = self.conv3d(xin[None], w, b, stride=(2, 1, 1))[0]
        x = self._res("encoder.middle.0", x)
        x = self._attention("encoder.middle.1", x)
        x = self._res("encoder.middle.2", x)
        x = self._cconv("encoder.head.2", F.silu(_norm(x, self.p["encoder.head.0.gamma"])))
        x = self.conv3d(x[None], self.p["conv1.weight"], self.p["conv1.bias"])[0]
        z = self.v["z_dim"]
        mean = torch.tensor(LATENT_MEAN, device=x.device)[:, None, None, None]
        std = torch.tensor(LATENT_STD, device=x.device)[:, None, None, None]
        return (x[:z] - mean) / std

    @torch.no_grad()
    def encode(self, clip_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (3, T, H, W) -> latents (16, 1 + (T - 1) / 4, H / 8, W / 8)."""
        self.cache: dict[str, torch.Tensor] = {}
        x = clip_u8.float() / 127.5 - 1.0
        outs = [self._chunk(x[:, :1], True)]
        for pos in range(1, x.shape[1], 4):
            outs.append(self._chunk(x[:, pos:pos + 4], False))
        return torch.cat([self.prec.round(z) for z in outs], dim=1)


# --------------------------------- training ---------------------------------


def train_schedule(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """The training noise levels: sigmas = shift(linspace(1, 1/N, N)),
    timesteps = N sigmas (descending)."""
    n, k = 1000, cfg["rectified_flow_shift"]
    s = np.linspace(1.0, 1.0 / n, n)
    s = k * s / (1.0 + (k - 1.0) * s)
    return s, s * n


def lr_factor(opt: dict, count: int) -> float:
    """LambdaLinear, one cycle: linear warm-up from f_start to f_max over
    warm_up_steps, then linear decay to f_min at cycle_length."""
    w, c = opt["warm_up_steps"], opt["cycle_length"]
    if count < w:
        return (opt["f_max"] - opt["f_start"]) / w * count + opt["f_start"]
    return opt["f_min"] + (opt["f_max"] - opt["f_min"]) * (c - count) / (c - w)


def power_ema_beta(count: int, s: float) -> float:
    """EDM2's power EMA: beta = (1 - 1/(i+1))^(gamma+1), gamma the largest
    real root of x^3 + 7x^2 + (16 - s^-2) x + (12 - s^-2); 0 at i = 0."""
    if count < 1:
        return 0.0
    gamma = float(np.roots([1, 7, 16 - s**-2, 12 - s**-2]).real.max())
    return (1.0 - 1.0 / (count + 1.0)) ** (gamma + 1.0)


class Trainer:
    """fp32 training of the reference DiT: loss, backward, clipping, AdamW, EMA."""

    def __init__(self, cfg: dict, traffic: dict, params: dict[str, torch.Tensor], precision=None,
                 altered: float = 1.0):
        """``altered`` != 1 scales each loss where it is produced: a planted
        fault, read on the chip to set the limits."""
        self.cfg, self.opt, self.altered = cfg, traffic["optimizer"], altered
        self.params = {n: p.requires_grad_(True) for n, p in params.items()}
        self.dit = R.DiT(cfg, self.params, precision)
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.ema = {n: p.detach().clone() for n, p in params.items()}
        self.count = 0
        self.sigmas, self.timesteps = train_schedule(cfg)

    def loss(self, x0: torch.Tensor, text: torch.Tensor, d: dict) -> torch.Tensor:
        """One sample's loss: x0 (C, T, H, W) fp32, text (M, Din), the draws ``d``."""
        idx = d["high_sigma_index"] if d["high_sigma"] else min(int(d["u"] * 1000), 999)
        s, t = float(np.float32(self.sigmas[idx])), float(np.float32(self.timesteps[idx]))
        eps = d["eps"]
        xt = eps * s + x0 * (1 - s)
        k = d["num_conditional_frames"]
        x_in = xt.clone()
        x_in[:, :k] = x0[:, :k] * float(d["use_video"])
        x_in = torch.cat([x_in, torch.zeros_like(x_in[:1])])[None]
        text = text * float(d["text_keep"])
        v = self.forward(x_in, torch.tensor([[t]], device=x0.device, dtype=torch.float32), text[None])[0]
        v = torch.cat([(eps - x0)[:, :k], v[:, k:]], dim=1)
        return self.cfg["loss_scale"] * ((v - (eps - x0)) ** 2).mean()

    def forward(self, x_in: torch.Tensor, t: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        dit = self.dit
        x = dit.patch_embed(x_in)
        B, T, H, Wd, D = x.shape
        grid = (T, H, Wd)
        emb, lora = (a[0, 0].expand(T, -1) for a in dit.time_embed(t))
        ctx = dit.caption(text)[0]
        x = x.reshape(T * H * Wd, D)
        for i in range(self.cfg["num_blocks"]):
            x = checkpoint(dit.block_all, i, x, emb, lora, ctx, grid, use_reentrant=False)
        return dit.final(x[None], emb[None], lora[None], grid)

    def step(self, x0, text, d) -> tuple[float, dict[str, float]]:
        """One training step; returns the loss and each leaf's clipped gradient norm."""
        for p in self.params.values():
            p.grad = None
        loss = self.loss(x0, text, d) * self.altered
        loss.backward()
        b1, b2 = self.opt["betas"]
        lr = self.opt["lr"] * lr_factor(self.opt, self.count)
        beta = power_ema_beta(self.count, self.opt["ema_rate"])
        self.count += 1
        with torch.no_grad():
            norm = float(torch.sqrt(sum(p.grad.double().square().sum() for p in self.params.values())))
            clip = self.opt["grad_clip_norm"]
            scale = clip / norm if norm >= clip else 1.0
            norms = {}
            for n, p in self.params.items():
                g = p.grad.mul_(scale)
                norms[n] = float(g.double().norm())
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[n] / (1 - b1 ** self.count)
                v_hat = self.v[n] / (1 - b2 ** self.count)
                p.mul_(1 - lr * self.opt["weight_decay"]).sub_(lr * m_hat / (v_hat.sqrt() + self.opt["eps"]))
                p.grad = None
                self.ema[n].mul_(beta).add_(p, alpha=1 - beta)
        return float(loss.detach()), norms

    @torch.no_grad()
    def changes(self, seed: int) -> dict[str, dict[str, float]]:
        """Each leaf's change of the parameters and of the EMA from the
        seed's weights (the moments are freed first)."""
        self.m = self.v = None
        start = {n: torch.empty_like(p) for n, p in self.params.items()}
        W.fill(W.dit_spec(self.cfg), start, seed)
        return {"update": {n: float((p - start[n]).double().norm()) for n, p in self.params.items()},
                "ema": {n: float((e - start[n]).double().norm()) for n, e in self.ema.items()}}


def leaf_gap(got: dict[str, float], want: dict[str, float], keep=None) -> float:
    """The worst leaf's gap of norms, |got - want| over the larger of want and
    the median leaf's want; ``keep`` names the leaves counted."""
    names = [n for n in want if keep is None or n in keep]
    median = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


def draws(cfg: dict, latent_shape, seed: int, step: int, device) -> dict:
    """One step's draws, made by the benchmark: text and video-condition
    dropout, conditional frames, noise, train time, the high-sigma pick."""
    gen = torch.Generator(device=device).manual_seed(W.stream_seed(seed, 40, step))
    rand = lambda: float(torch.rand((), generator=gen, device=device))
    probs = cfg["conditional_frames_probs"]
    r, k = rand(), probs[-1][0]
    acc = 0.0
    for frames, p in probs:
        acc += p
        if r < acc:
            k = frames
            break
    sigmas, timesteps = train_schedule(cfg)
    candidates = np.nonzero((timesteps >= cfg["high_sigma_timesteps_min"]) & (timesteps <= cfg["high_sigma_timesteps_max"]))[0]
    return {
        "text_keep": rand() < 1 - cfg["text_dropout_rate"],
        "use_video": rand() < 1 - cfg["video_cond_dropout_rate"],
        "num_conditional_frames": k,
        "u": float(torch.sigmoid(torch.randn((), generator=gen, device=device))),
        "high_sigma": cfg["use_high_sigma_strategy"] and rand() < cfg["high_sigma_ratio"],
        "high_sigma_index": int(candidates[int(rand() * len(candidates)) % len(candidates)]),
        "eps": torch.randn(latent_shape, generator=gen, device=device),
    }
