"""Time the fused forward-mode flash attention (K9) against variants of its
source and, optionally, another checkout's K9, on the card.

    python -m cosmos_predict2_tpu_torch.scripts.jvp_variants [--baseline DIR] [--out FILE]

Cases: chip_smoke.py's K9 cases, batch 1, 16 heads: 8,320 tokens
(scripts/fa_jvp.py's shape), 5,760 (the smoke geometry's self-attention)
and 1,000 with frame_group 256 (a kv tail). A variant is
``csrc/flash_attention_jvp.cu`` with constants changed (VARIANTS: one
consumer warpgroup of 64 q rows per CTA; S and dS committed as one group,
not two, so the softmax of S waits for dS), compiled with the
package's nvcc flags into a library of its own and called through the same
C entry point as the built kernel; its outputs are compared with the built
kernel's (bits, and relative L2). Beside them K1 at the same shape (each
forward-mode call launches K1 and K9). ``--baseline DIR`` times the K9 of
the checkout in DIR (for example the parent commit unpacked with ``git
archive``) through that checkout's own wrapper, in a subprocess, before and
after this tree's runs, on the same seeded inputs. Prints one line per
case (with the rate on the 12 B H Sq Skv 128 FLOPs of the visible pairs)
and a JSON summary (mean ms) with the card's name and power limit. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

# only names that a baseline checkout's package has too (time_tree runs
# there), and the shared helpers of this tree (_kernel_variants.time_baseline)
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_fwd
from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_jvp
from cosmos_predict2_tpu_torch.scripts._kernel_variants import build_variant, cuda_ms, finish, time_baseline

# (patches, the launch register count its setmaxnreg budget needs or None
# without one, whether it may spill: S and dS in one group spills 20 bytes)
VARIANTS = {
    "one_wg": ([("constexpr int kConsumerWGs = 2;", "constexpr int kConsumerWGs = 1;")], None, False),
    "one_group": ([("constexpr bool kTwoGroups = true;", "constexpr bool kTwoGroups = false;")], 168, True),
}
# (label, S, frame_group, timed calls)
CASES = [("S8320", 8320, 0, 5), ("S5760", 5760, 0, 5), ("S1000 frame_group=256", 1000, 256, 20)]
HEADS, SEED = 16, 0
PEAK_BF16_FLOPS = 989e12


def case_inputs(s: int):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return [torch.randn((1, s, HEADS, 128), generator=gen, device="cuda").bfloat16() for _ in range(6)]


class Library:
    """K9 through a kernel library's C entry point: the built library, or one
    compiled from a patched copy of the source."""

    def __init__(self, name: str, patches: list[tuple[str, str]] | None = None, launch_regs: int | None = None,
                 allow_spill: bool = False):
        self.name = name
        if patches is None:
            self.lib = _build.library()
            return
        self.lib = build_variant("flash_attention_jvp.cu", name, patches, "flash_attention_jvp_kernel",
                                 launch_regs=launch_regs, allow_spill=allow_spill)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.cosmos_flash_attention_jvp.argtypes = [p] * 8 + [i] * 5 + [f, p]

    def k9(self, q, k, v, dq, dk, dv, fg):
        out, dout = torch.empty_like(q), torch.empty_like(q)
        err = self.lib.cosmos_flash_attention_jvp(*(t.data_ptr() for t in (q, k, v, dq, dk, dv, out, dout)), 1,
                                                  q.shape[1], k.shape[1], HEADS, fg, 128**-0.5,
                                                  torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} K9")
        return out, dout


def time_tree() -> dict:
    """This checkout's K9 at the cases, through its wrapper: {label: ms}."""
    times = {}
    for label, s, fg, iters in CASES:
        x = case_inputs(s)
        times[f"K9 {label}"] = cuda_ms(lambda: flash_attention_jvp(*x, frame_group=fg), iters)
        del x
        torch.cuda.empty_cache()
    return times


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another checkout whose K9 to time alongside")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("jvp_variants: needs a CUDA card")
    built = Library("built")
    variants = [Library(name, *spec) for name, spec in VARIANTS.items()]
    summary: dict = {"baseline": [], "tree": [], "variants": {}, "k1": {}, "tflops": {}}
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    summary["tree"].append(time_tree())
    for label, s, fg, iters in CASES:
        x = case_inputs(s)
        ref = built.k9(*x, fg)
        pairs = s * s if fg <= 0 else int(np.minimum(s, (np.arange(s) // fg + 1) * fg).sum())
        flops = 12 * HEADS * pairs * 128
        ms = cuda_ms(lambda: built.k9(*x, fg), iters)
        summary["tflops"][f"K9 {label}"] = flops / ms / 1e9
        line = [f"K9 {label}: built {ms:.3f} ms ({flops / ms / 1e9:.0f} TFLOP/s, "
                f"{flops / ms / 1e9 / PEAK_BF16_FLOPS * 1e12:.1%} of the bf16 peak)"]
        for var in variants + variants[::-1]:  # each variant twice, in turns
            got = var.k9(*x, fg)
            ms = cuda_ms(lambda: var.k9(*x, fg), iters)
            summary["variants"].setdefault(var.name, {}).setdefault(f"K9 {label}", []).append(ms)
            line.append(f"{var.name} {ms:.3f} ms (same bits {torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])}, "
                        f"rel o {rel(got[0], ref[0]):.1e} do {rel(got[1], ref[1]):.1e})")
        summary["k1"][f"K9 {label}"] = cuda_ms(lambda: flash_attention_fwd(*x[:3], frame_group=fg), iters)
        line.append(f"K1 {summary['k1'][f'K9 {label}']:.3f} ms")
        print(" | ".join(line), flush=True)
        del x, ref
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
