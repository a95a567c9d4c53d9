"""Time the row-windowed KV-cache decode (K6) against variants of its
source and, optionally, another checkout's K6, on the card.

    python -m cosmos_predict2_tpu_torch.scripts.kv_window_variants [--baseline DIR] [--out FILE]

Cases: chip_smoke.py's five K6 cases, batch 1, 16 heads, a block of one
frame (two for nb2) over a cache of whole frames: 352x640 (22 x 40 tokens,
7 of 22 rows) at the steady state (17 filled frames) and early (4), two
frames a block (18 filled), 720p (44 x 80, 14 of 44 rows, 9 filled) and a
prime row count (23 x 40, 17 filled). A variant is
``csrc/flash_attention_fwd.cu`` with constants changed (VARIANTS: 64-row
kv tiles), compiled with the package's nvcc flags into a library of its
own and called through the same C entry point as the built kernel; its
outputs are compared with the built kernel's (bits, and relative L2). The
built K6 is also called at every split count of its frame walk from 1 to
SPLIT_SWEEP, beside the count ``kv_window_split_plan`` picks. Beside them:
K5 over the same cache (the dense decode) and masked SDPA over the filled
cache, the yardstick. ``--baseline DIR`` times the K6 of the checkout in
DIR (for example the parent commit unpacked with ``git archive``) through
that checkout's own wrapper, in a subprocess, before and after this
tree's runs, on the same seeded inputs. Prints one line per case (with
the pairs each tile choice loads and computes against the visible ones)
and a JSON summary (mean ms) with the card's name and power limit. Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

# only names that a baseline checkout's package has too (time_tree runs
# there), and the shared helpers of this tree (_kernel_variants.time_baseline)
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_kv_cache_window
from cosmos_predict2_tpu_torch.scripts._kernel_variants import build_variant, cuda_ms, finish, time_baseline

VARIANTS = {"kv64": [("constexpr int kWindowBlockKV = 128;", "constexpr int kWindowBlockKV = 64;")]}
# (label, gh, gw, frames per block, filled frames, window rows, timed calls)
CASES = [("352x640 steady", 22, 40, 1, 17, 7, 20), ("352x640 early", 22, 40, 1, 4, 7, 20),
         ("352x640 nb2", 22, 40, 2, 18, 7, 20), ("720p", 44, 80, 1, 9, 14, 10),
         ("prime gh 23x40", 23, 40, 1, 17, 7, 20)]
SPLIT_SWEEP = 4
HEADS, SEED = 16, 0


def case_inputs(gh: int, gw: int, nb: int, filled: int):
    """Seeded q (1, Sq, H, 128) and head-major buffers one frame longer
    than the fill, NaN past it (the kernel must keep it out)."""
    F = gh * gw
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((1, nb * F, HEADS, 128), generator=gen, device="cuda").bfloat16()
    kb, vb = (torch.randn((1, HEADS, (filled + 1) * F, 128), generator=gen, device="cuda").bfloat16() for _ in range(2))
    kb[:, :, filled * F:] = float("nan")
    vb[:, :, filled * F:] = float("nan")
    return q, kb, vb


class Library:
    """K6 through a kernel library's C entry point at a given split count;
    the built library, or one compiled from a patched copy of the source."""

    def __init__(self, name: str, patches: list[tuple[str, str]] | None = None):
        self.name = name
        if patches is None:
            self.lib = _build.library()
            return
        self.lib = build_variant("flash_attention_fwd.cu", name, patches, "flash_kv_cache_window_kernel",
                                 launch_regs=168)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.cosmos_flash_kv_cache_window.argtypes = [p] * 6 + [i] * 9 + [f, p]

    def k6(self, q, kb, vb, fill, grid_hw, wh, splits=1):
        out = torch.empty_like(q)
        gh, gw = grid_hw
        rows = splits * q.shape[1] * HEADS
        scratch = torch.empty(rows * 129, dtype=torch.float32, device="cuda") if splits > 1 else None
        ptrs = (None, None) if scratch is None else (scratch.data_ptr(), scratch[rows * 128:].data_ptr())
        err = self.lib.cosmos_flash_kv_cache_window(q.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), *ptrs,
                                                    1, q.shape[1], kb.shape[2], HEADS, fill, gh, gw, min(wh, gh),
                                                    splits, 128**-0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} K6 splits {splits}")
        return out


def time_tree() -> dict:
    """This checkout's K6 at the cases, through its wrapper: {label: ms}."""
    times = {}
    for label, gh, gw, nb, filled, wh, iters in CASES:
        q, kb, vb = case_inputs(gh, gw, nb, filled)
        fill = filled * gh * gw
        times[f"K6 {label}"] = cuda_ms(lambda: flash_attention_kv_cache_window(q, kb, vb, fill, (gh, gw), wh), iters)
        del q, kb, vb
        torch.cuda.empty_cache()
    return times


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def main(argv=None) -> int:
    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        flash_attention_kv_cache,
        kv_window_split_plan,
        window_rows_bounds,
        window_walk_pairs,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another checkout whose K6 to time alongside")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kv_window_variants: needs a CUDA card")
    built = Library("built")
    variants = [Library(name, patch) for name, patch in VARIANTS.items()]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    summary: dict = {"baseline": [], "tree": [], "variants": {}, "splits": {}, "k5": {}, "library": {}, "pairs": {}}
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    summary["tree"].append(time_tree())
    for label, gh, gw, nb, filled, wh, iters in CASES:
        q, kb, vb = case_inputs(gh, gw, nb, filled)
        F, Sq = gh * gw, nb * gh * gw
        fill = filled * F
        ref = built.k6(q, kb, vb, fill, (gh, gw), wh)
        pairs = {f"q{bq}/kv{bk}": window_walk_pairs(Sq, fill, (gh, gw), wh, bq, bk)
                 for bq, bk in ((64, 64), (128, 64), (128, 128))}
        summary["pairs"][label] = pairs
        line = [f"K6 {label}: built {cuda_ms(lambda: built.k6(q, kb, vb, fill, (gh, gw), wh), iters):.4f} ms"]
        for var in variants + variants[::-1]:  # each variant twice, in turns
            got = var.k6(q, kb, vb, fill, (gh, gw), wh)
            ms = cuda_ms(lambda: var.k6(q, kb, vb, fill, (gh, gw), wh), iters)
            summary["variants"].setdefault(var.name, {}).setdefault(f"K6 {label}", []).append(ms)
            line.append(f"{var.name} {ms:.4f} ms (same bits {torch.equal(got, ref)}, rel {rel(got, ref):.1e})")
        planned = kv_window_split_plan(Sq, fill, (gh, gw), wh, HEADS, 1, sms)
        times = {}
        for splits in list(range(1, SPLIT_SWEEP + 1)) + list(range(SPLIT_SWEEP, 0, -1)):
            if splits <= filled:
                times.setdefault(splits, []).append(
                    cuda_ms(lambda: built.k6(q, kb, vb, fill, (gh, gw), wh, splits), iters))
        summary["splits"][label] = {"planned": planned, "ms": times}
        line.append(f"splits (plan: {planned}) " + " ".join(f"{s}:{sum(t) / len(t):.4f}" for s, t in times.items()))
        summary["k5"][f"K6 {label}"] = cuda_ms(lambda: flash_attention_kv_cache(q, kb, vb, fill), iters)
        lo, hi = window_rows_bounds(torch.arange(Sq, device="cuda"), (gh, gw), wh)
        yk = (torch.arange(fill, device="cuda") % F) // gw
        mask = (yk[None, :] >= lo[:, None]) & (yk[None, :] < hi[:, None])
        qh, kh, vh = q.transpose(1, 2), kb[:, :, :fill], vb[:, :, :fill]
        summary["library"][f"K6 {label}"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), iters)
        line.append(f"K5 {summary['k5'][f'K6 {label}']:.4f} ms | masked SDPA {summary['library'][f'K6 {label}']:.4f} ms")
        line.append("pairs over visible " + " ".join(
            f"{k} loaded {v['loaded'] / v['visible']:.3f} computed {v['computed'] / v['visible']:.3f}"
            for k, v in pairs.items()))
        print(" | ".join(line), flush=True)
        del q, kb, vb, ref, qh, kh, vh, mask
        torch.cuda.empty_cache()
    summary["tree"].append(time_tree())
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    for who in ("tree", "baseline"):
        for run in summary[who]:
            print(who, " ".join(f"{label}: {t:.4f}" for label, t in run.items()), flush=True)
    finish(summary, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
