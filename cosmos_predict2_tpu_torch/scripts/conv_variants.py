"""Time the causal conv (K2) against variants of its source, beside cuDNN
and, optionally, another checkout's K2, on the card.

    python -m cosmos_predict2_tpu_torch.scripts.conv_variants [--baseline DIR] [--repeats N] [--out FILE]

Cases: chip_smoke.py's conv cases (each stage of the smoke geometry's
streaming encode and decode, then the 720p decoder's shapes). A variant is
``csrc/conv3d_causal.cu`` with constants changed (VARIANTS: how many taps'
A operands are loaded from the slab together), compiled with the package's
nvcc flags into a library of its own and called through the same C entry
point as the built kernel with the plan of ops/conv3d.py::conv_plan; its
outputs are compared with the built kernel's (bits) and with the fp32
plain version (relative L2). ``--repeats N`` calls the built kernel N more
times per case and counts the calls whose bits differ from its first.
``--baseline DIR`` times the K2 of the checkout in DIR (for example the
parent commit unpacked with ``git archive``) through that checkout's own
wrapper, in a subprocess, before and after this tree's runs, on the same
seeded inputs. Prints one line per case with each kernel's time (built,
then each variant, then the same in reverse), its rate, and a JSON summary
(every time, ms, and the share of the bf16 peak) with the card's name and
power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch
import torch.nn.functional as F

# only names that a baseline checkout's package has too (time_tree runs
# there), and the shared helpers of this tree (_kernel_variants.time_baseline)
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal
from cosmos_predict2_tpu_torch.scripts._kernel_variants import build_variant, cuda_ms, finish, time_baseline

VARIANTS = {f"batch{n}": [("constexpr int kSlabBatchTaps = 9;", f"constexpr int kSlabBatchTaps = {n};")]
            for n in (1, 3)}
# (label, T_out, H, W, Cin, Cout, timed calls)
CASES = [
    ("enc T4 192x320 96->96", 4, 192, 320, 96, 96, 10),
    ("enc T4 96x160 96->192", 4, 96, 160, 96, 192, 10),
    ("enc T2 48x80 192->384", 2, 48, 80, 192, 384, 10),
    ("enc T1 24x40 384->384", 1, 24, 40, 384, 384, 10),
    ("dec T2 24x40 384->384", 2, 24, 40, 384, 384, 10),
    ("dec T4 48x80 192->384", 4, 48, 80, 192, 384, 10),
    ("dec T8 96x160 192->192", 8, 96, 160, 192, 192, 10),
    ("dec T8 192x320 96->96", 8, 192, 320, 96, 96, 10),
    ("dec T2 176x320 384->384 (720p)", 2, 176, 320, 384, 384, 5),
    ("dec T4 352x640 192->192 (720p)", 4, 352, 640, 192, 192, 5),
    ("dec T4 704x1280 96->96 (720p)", 4, 704, 1280, 96, 96, 5),
]
SEED = 0
PEAK_BF16_FLOPS = 989e12


def case_inputs(T, H, W, cin, cout):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((1, T + 2, H, W, cin), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((3, 3, 3, cin, cout), generator=gen, device="cuda") / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn((cout,), generator=gen, device="cuda")
    return x, w, b


def time_tree() -> dict:
    """This checkout's K2 at the cases, through its wrapper: {label: ms}."""
    times = {}
    for label, T, H, W, cin, cout, iters in CASES:
        x, w, b = case_inputs(T, H, W, cin, cout)
        times[label] = cuda_ms(lambda: conv3d_causal(x, w, b), iters)
        del x, w, b
        torch.cuda.empty_cache()
    return times


def entry_call(lib, x, w_taps, bias, plan) -> torch.Tensor:
    """K2 through a kernel library's C entry point."""
    _, T_in, H, W, Cin = x.shape
    Cout = w_taps.shape[1]
    out = torch.empty((1, T_in - 2, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    err = lib.cosmos_conv3d_causal(x.data_ptr(), w_taps.data_ptr(), bias.data_ptr(), out.data_ptr(), T_in - 2, H, W,
                                   Cin, Cout, plan.box_w, plan.n, plan.n_split, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3d_causal")
    return out


def variant_library(name: str, patches) -> ctypes.CDLL:
    lib = build_variant("conv3d_causal.cu", name, patches, "conv3d_causal_kernel", launch_regs=168)
    lib.cosmos_conv3d_causal.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal_plain, conv_plan, conv_weight_taps

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another checkout whose K2 to time alongside")
    ap.add_argument("--repeats", type=int, default=0, help="extra calls of the built kernel per case, held to its bits")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_variants: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    runs = [("built", _build.library())] + [(name, variant_library(name, p)) for name, p in VARIANTS.items()]
    summary: dict = {"baseline": [], "tree": [], "variants": {}, "cudnn": {}, "share_of_peak": {}, "repeats_differing": {}}
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    summary["tree"].append(time_tree())
    for label, T, H, W, cin, cout, iters in CASES:
        x, w, b = case_inputs(T, H, W, cin, cout)
        taps, bias, plan = conv_weight_taps(w), b.float().contiguous(), conv_plan(H, W, cin, cout)
        ref = conv3d_causal_plain(x, w, b, out_dtype=torch.float32)
        flops = 2 * T * H * W * 27 * cin * cout
        line = [f"{label} {plan.box_h}x{plan.box_w} n {plan.n} x {plan.n_split}"]
        first = entry_call(runs[0][1], x, taps, bias, plan)
        for name, lib in runs + runs[::-1]:  # each twice, in turns
            out = entry_call(lib, x, taps, bias, plan)
            rel = float((out.float() - ref).norm() / ref.norm())
            ms = cuda_ms(lambda: entry_call(lib, x, taps, bias, plan), iters)
            summary["variants"].setdefault(name, {}).setdefault(label, []).append(ms)
            summary["share_of_peak"].setdefault(name, {})[label] = flops / ms / 1e9 / PEAK_BF16_FLOPS * 1e12
            line.append(f"{name} {ms:.3f} ms ({flops / ms / 1e9:.0f} TF/s, rel_l2 {rel:.2e}, "
                        f"same bits {torch.equal(out, first)})")
        differing = sum(not torch.equal(entry_call(runs[0][1], x, taps, bias, plan), first) for _ in range(args.repeats))
        summary["repeats_differing"][label] = differing
        xc, wc, bc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous(), b.bfloat16()
        summary["cudnn"][label] = cuda_ms(lambda: F.conv3d(xc, wc, bc, padding=(0, 1, 1)), iters)
        line.append(f"cudnn {summary['cudnn'][label]:.3f} ms; {differing} of {args.repeats} repeats differ")
        print(" | ".join(line), flush=True)
        del x, w, b, taps, bias, ref, first, out, xc, wc, bc
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
