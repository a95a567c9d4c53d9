"""Time the flash-attention forward (K1) and the KV-cache decode (K5)
against variants of their source, K5 at each split count, and optionally
another checkout's K1 and K5, on the card.

    python -m cosmos_predict2_tpu_torch.scripts.flash_fwd_variants [--baseline DIR] [--out FILE]

A variant is ``csrc/flash_attention_fwd.cu`` with constants changed
(VARIANTS: 64-row kv tiles; a three-stage ring), compiled with the
package's nvcc flags into a library of its own and called through the same
C entry points as the built kernels; its outputs are compared with the
built kernels' (bits, and relative L2). K5 is also called through the built
library at every split count from 1 to SPLIT_SWEEP at each cache shape,
beside the count ``kv_cache_split_plan`` picks. ``--baseline DIR`` times
the K1 and K5 of the checkout in DIR (for example the parent commit
unpacked with ``git archive``) through that checkout's own wrappers, in a
subprocess, before and after this tree's runs, on the same seeded inputs.
Shapes: K1 at B2 H16 self-attention at 5,760 tokens, cross-attention to
512 keys, frame group 240 (B1) and 720p self-attention (84,480 tokens,
B1); K5 at B1 H16 over the interactive path's 352x640 cache at full and
early fill and a 720p one. Prints one line per shape and a JSON summary
(mean ms) with the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

# only names that a baseline checkout's package has too (time_tree runs
# there), and the shared helpers of this tree (_kernel_variants.time_baseline)
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_kv_cache
from cosmos_predict2_tpu_torch.scripts._kernel_variants import build_variant, cuda_ms, finish, time_baseline

VARIANTS = {
    "kv64": [("constexpr int kBlockKV = 128;", "constexpr int kBlockKV = 64;")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}
# (label, B, Sq, Skv, frame_group, timed calls)
K1_SHAPES = [("self 5760", 2, 5760, 5760, 0, 10), ("cross 5760/512", 2, 5760, 512, 0, 10),
             ("fg240 5760", 1, 5760, 5760, 240, 10), ("720p self", 1, 84480, 84480, 0, 1)]
# (label, Sq, filled tokens, buffer tokens, timed calls)
K5_SHAPES = [("352x640 steady", 880, 17 * 880, 17 * 880, 20), ("352x640 early", 880, 4 * 880, 17 * 880, 20),
             ("352x640 nb2", 1760, 18 * 880, 18 * 880, 20), ("720p", 3520, 9 * 3520, 9 * 3520, 10)]
SPLIT_SWEEP = 8
HEADS, SEED = 16, 0


def k1_inputs(b: int, sq: int, skv: int):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((b, sq, HEADS, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, skv, HEADS, 128), generator=gen, device="cuda").bfloat16() for _ in range(2))
    return q, k, v


def k5_inputs(sq: int, fill: int, s_max: int):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((1, sq, HEADS, 128), generator=gen, device="cuda").bfloat16()
    kb, vb = (torch.randn((1, HEADS, s_max, 128), generator=gen, device="cuda").bfloat16() for _ in range(2))
    return q, kb, vb


class Library:
    """K1 and K5 through a kernel library's C entry points (K5 at a given
    split count); the built library, or one compiled from a patched copy of
    the source."""

    def __init__(self, name: str, patches: list[tuple[str, str]] | None = None):
        self.name = name
        if patches is None:
            self.lib = _build.library()
            return
        self.lib = build_variant("flash_attention_fwd.cu", name, patches,
                                 ("flash_attention_fwd_kernel", "flash_kv_cache_kernel"), launch_regs=168)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.cosmos_flash_attention_fwd.argtypes = [p] * 5 + [i] * 5 + [f, p]
        self.lib.cosmos_flash_kv_cache.argtypes = [p] * 6 + [i] * 6 + [f, p]

    def k1(self, q, k, v, fg):
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[0], HEADS, q.shape[1]), dtype=torch.float32, device="cuda")
        err = self.lib.cosmos_flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                  lse.data_ptr(), q.shape[0], q.shape[1], k.shape[1], HEADS, fg,
                                                  128**-0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} K1")
        return out, lse

    def k5(self, q, kb, vb, fill, splits):
        out = torch.empty_like(q)
        rows = splits * q.shape[1] * HEADS
        scratch = torch.empty(rows * 129, dtype=torch.float32, device="cuda") if splits > 1 else None
        ptrs = (None, None) if scratch is None else (scratch.data_ptr(), scratch[rows * 128:].data_ptr())
        err = self.lib.cosmos_flash_kv_cache(q.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), *ptrs, 1,
                                             q.shape[1], kb.shape[2], HEADS, fill, splits, 128**-0.5,
                                             torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} K5 splits {splits}")
        return out


def time_tree() -> dict:
    """This checkout's K1 and K5 at their shapes, through its wrappers: {label: ms}."""
    times = {}
    for label, b, sq, skv, fg, iters in K1_SHAPES:
        q, k, v = k1_inputs(b, sq, skv)
        times[f"K1 {label}"] = cuda_ms(lambda: flash_attention_fwd(q, k, v, frame_group=fg), iters)
        del q, k, v
        torch.cuda.empty_cache()
    for label, sq, fill, s_max, iters in K5_SHAPES:
        q, kb, vb = k5_inputs(sq, fill, s_max)
        times[f"K5 {label}"] = cuda_ms(lambda: flash_attention_kv_cache(q, kb, vb, fill), iters)
        del q, kb, vb
        torch.cuda.empty_cache()
    return times


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def main(argv=None) -> int:
    from cosmos_predict2_tpu_torch.ops.flash_attention import kv_cache_split_plan

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another checkout whose K1 and K5 to time alongside")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_variants: needs a CUDA card")
    built = Library("built")
    variants = [Library(name, patch) for name, patch in VARIANTS.items()]
    summary: dict = {"baseline": [], "tree": [], "variants": {}, "splits": {}, "library": {}}
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    summary["tree"].append(time_tree())
    for label, b, sq, skv, fg, iters in K1_SHAPES:
        q, k, v = k1_inputs(b, sq, skv)
        ref = built.k1(q, k, v, fg)
        line = [f"K1 {label}: built {cuda_ms(lambda: built.k1(q, k, v, fg), iters):.3f} ms"]
        for var in variants + variants[::-1]:  # each variant twice, in turns
            got = var.k1(q, k, v, fg)
            ms = cuda_ms(lambda: var.k1(q, k, v, fg), iters)
            summary["variants"].setdefault(var.name, {}).setdefault(f"K1 {label}", []).append(ms)
            line.append(f"{var.name} {ms:.3f} ms (same bits {torch.equal(got[0], ref[0])}, "
                        f"rel {rel(got[0], ref[0]):.1e})")
        mask = None
        if fg:
            idx = torch.arange(sq, device="cuda")
            mask = (idx[None, :skv] // fg) <= (idx[:, None] // fg)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        try:
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                             iters)
        except torch.OutOfMemoryError:
            lib_ms = None
        summary["library"][f"K1 {label}"] = lib_ms
        print(" | ".join(line) + f" | SDPA {lib_ms} ms", flush=True)
        del q, k, v, ref, qt, kt, vt, mask
        torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, sq, fill, s_max, iters in K5_SHAPES:
        q, kb, vb = k5_inputs(sq, fill, s_max)
        ref = built.k5(q, kb, vb, fill, 1)
        planned = kv_cache_split_plan(sq, fill, HEADS, 1, sms).splits
        times = {}
        for splits in list(range(1, SPLIT_SWEEP + 1)) + list(range(SPLIT_SWEEP, 0, -1)):
            times.setdefault(splits, []).append(cuda_ms(lambda: built.k5(q, kb, vb, fill, splits), iters))
        summary["splits"][label] = {"planned": planned, "ms": times}
        line = [f"K5 {label} (plan: {planned} splits): " + " ".join(
            f"{s}:{sum(t) / len(t):.3f}" for s, t in times.items())]
        for var in variants + variants[::-1]:
            got = var.k5(q, kb, vb, fill, 1)
            ms = cuda_ms(lambda: var.k5(q, kb, vb, fill, 1), iters)
            summary["variants"].setdefault(var.name, {}).setdefault(f"K5 {label}", []).append(ms)
            line.append(f"{var.name} {ms:.3f} ms (same bits {torch.equal(got, ref)}, rel {rel(got, ref):.1e})")
        qh, kh, vh = q.transpose(1, 2), kb[:, :, :fill], vb[:, :, :fill]
        summary["library"][f"K5 {label}"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh), iters)
        print(" | ".join(line) + f" | SDPA {summary['library'][f'K5 {label}']:.3f} ms", flush=True)
        del q, kb, vb, ref, qh, kh, vh
        torch.cuda.empty_cache()
    summary["tree"].append(time_tree())
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    for who in ("tree", "baseline"):
        for run in summary[who]:
            print(who, " ".join(f"{label}: {t:.3f}" for label, t in run.items()), flush=True)
    finish(summary, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
