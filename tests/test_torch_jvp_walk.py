"""The fused forward-mode flash attention (K9) in its kernel's order, in
plain PyTorch on the CPU, held against the JAX package's K9.

The kernel (csrc/flash_attention_jvp.cu): per 128-row q tile, two consumer
warpgroups of 64 rows walk 64-row kv tiles up to the last frame group any
row of the q tile sees; a warpgroup skips the tiles past the last frame
group its own rows see and masks only the tiles past the keys all its rows
see (the kv tail and the frame mask, logits -1e30 and P = 0). Per tile:
S = scale Q K^T and dS = dQ K^T + Q dK^T, the online softmax on S, P*dS =
P dS scale, P and P*dS rounded to v's and dv's dtype before
acc_o += P V, acc_t += (P*dS) V + P dV; at the end o = acc_o / l and
do = acc_t / l - (r / l) o with o the fp32 quotient.

Held in fp32 against JAX's ``_jvp_bhsd`` under
``pltpu.force_tpu_interpret_mode()`` and ``reference_attention_jvp``, and
against the port's ``flash_attention_jvp_plain``, at tests/test_flash_jvp.py's
tolerances (atol 3e-5 on o, 3e-4 on do: the same online softmax in another
summation order), on chip_smoke.py's kv-tail case (S 1000 with frame_group
256, at 2 heads), a kv tail without a frame group, a frame group that
splits a warpgroup's rows and the dv-only tangents.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops.flash_attention_jvp import _jvp_bhsd, reference_attention_jvp
from cosmos_predict2_tpu_torch.ops.flash_attention import NEG_INF
from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_jvp_plain

Q, KV, WG = 128, 64, 64  # kBlockQ, kBlockKV and a consumer warpgroup's rows in the kernel
O_ATOL, DO_ATOL = 3e-5, 3e-4

# (S, frame_group, inputs with a tangent)
CASES = [(1000, 256, "qkv"), (200, 0, "qkv"), (384, 96, "qk"), (256, 0, "v")]


def jvp_by_walk(q, k, v, dq, dk, dv, frame_group):
    """K9's function in its own order (see the module docstring), BSHD in
    and out."""
    B, sq, H, D = q.shape
    skv = k.shape[1]
    scale = 1.0 / D**0.5
    fg = frame_group
    bh = lambda t: t.permute(0, 2, 1, 3).float()  # noqa: E731
    q, k, v, dq, dk, dv = map(bh, (q, k, v, dq, dk, dv))
    o_out, do_out = torch.zeros_like(q), torch.zeros_like(q)
    kv_end = lambda row: min(skv, (row // fg + 1) * fg) if fg > 0 else skv  # noqa: E731
    for q0 in range(0, sq, Q):
        n_tiles = -(-kv_end(min(q0 + Q, sq) - 1) // KV)
        for w in range(Q // WG):
            rows = np.arange(q0 + w * WG, min(q0 + (w + 1) * WG, sq))
            if not len(rows):
                continue
            wg_full, wg_end = kv_end(rows[0]), kv_end(rows[-1])
            kmax = torch.tensor([kv_end(r) for r in rows])
            qr, dqr = q[:, :, rows], dq[:, :, rows]
            m = torch.full((B, H, len(rows), 1), NEG_INF)
            l, r = torch.zeros((B, H, len(rows), 1)), torch.zeros((B, H, len(rows), 1))
            acc_o, acc_t = torch.zeros((B, H, len(rows), D)), torch.zeros((B, H, len(rows), D))
            for it in range(min(n_tiles, -(-wg_end // KV))):
                cols = torch.arange(it * KV, (it + 1) * KV)
                pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, KV))[:, :, it * KV:(it + 1) * KV]  # noqa: E731
                kt, dkt, vt, dvt = pad(k), pad(dk), pad(v), pad(dv)  # zeros past skv, as TMA reads them
                s = qr @ kt.transpose(-1, -2)
                ds = dqr @ kt.transpose(-1, -2) + qr @ dkt.transpose(-1, -2)
                masked = (it + 1) * KV > wg_full
                visible = cols[None, :] < kmax[:, None]
                if masked:
                    s = s.masked_fill(~visible, NEG_INF / scale)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
                p = torch.exp(s * scale - m_new)
                if masked:
                    p = p.masked_fill(~visible, 0.0)
                corr = torch.exp(m - m_new)
                pds = p * ds * scale
                l = l * corr + p.sum(-1, keepdim=True)
                r = r * corr + pds.sum(-1, keepdim=True)
                acc_o = acc_o * corr + p.to(v.dtype) @ vt
                acc_t = acc_t * corr + pds.to(v.dtype) @ vt + p.to(dv.dtype) @ dvt
                m = m_new
            o = acc_o / l
            o_out[:, :, rows] = o
            do_out[:, :, rows] = acc_t / l - (r / l) * o
    bshd = lambda t: t.permute(0, 2, 1, 3)  # noqa: E731
    return bshd(o_out), bshd(do_out)


def _inputs(S, tangents, seed=3):
    rng = np.random.default_rng(seed)
    prim = [rng.standard_normal((1, S, 2, 128)).astype(np.float32) for _ in range(3)]
    tang = [rng.standard_normal((1, S, 2, 128)).astype(np.float32) if name in tangents
            else np.zeros((1, S, 2, 128), np.float32) for name in "qkv"]
    return prim, tang


@pytest.fixture(scope="module", params=CASES, ids=[f"S{s}-fg{fg}-{t}" for s, fg, t in CASES])
def case(request):
    S, fg, tangents = request.param
    prim, tang = _inputs(S, tangents)
    got = jvp_by_walk(*map(torch.from_numpy, prim + tang), fg)
    return S, fg, prim, tang, got


def _close(got, want_o, want_do):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_o), atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_do), atol=DO_ATOL, rtol=0)


def test_kernel_order_matches_the_pallas_kernel_interpreted(case):
    _, fg, prim, tang, got = case
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731  BSHD <-> BHSD
    with pltpu.force_tpu_interpret_mode():
        o, do = _jvp_bhsd(*map(tr, prim + tang), frame_group=fg)
    _close(got, tr(o), tr(do))


def test_kernel_order_matches_jax_reference(case):
    _, fg, prim, tang, got = case
    _close(got, *reference_attention_jvp(*map(jnp.asarray, prim + tang), fg))


def test_kernel_order_matches_plain(case):
    _, fg, prim, tang, got = case
    _close(got, *(t.numpy() for t in flash_attention_jvp_plain(*map(torch.from_numpy, prim + tang), fg)))
