"""Time neighborhood attention's forward (K10), dQ (K11) and dK/dV (K12)
against variants of their source and, optionally, another checkout's
kernels, on the card.

    python -m cosmos_predict2_tpu_torch.scripts.na_variants [--baseline DIR] [--out FILE]

Cases: chip_smoke.py's four neighborhood-attention cases, 16 heads: the 2B
sparse config's window adapted to the smoke geometry (24 x 12 x 20 tokens;
K10 at batch 2 as in batched CFG), at 720p (24 x 44 x 80) and at 480p
(24 x 30 x 52, H and W padded to the tiles), and layer 0 of the 14B
comb02 list (dilated) at 720p; K11, K12 and the other K10 cases at batch 1.
A variant is ``csrc/neighborhood_attention.cu`` with constants changed
(VARIANTS: the depth of K10's and K12's ring, and of K11's), compiled with
the package's nvcc flags into a library of its own and called through the
same C entry points as the built kernels; its outputs are compared with
the built kernels' (bits).
``--baseline DIR`` times the K10-K12 of the checkout in DIR (for
example the parent commit unpacked with ``git archive``) through that
checkout's own wrappers, in a subprocess, before and after this tree's
runs, on the same seeded inputs. Prints one line per case (with the rate
on the pairs each kernel's walk computes) and a JSON summary (mean ms)
with the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

# only names that a baseline checkout's package has too (time_tree runs
# there), and the shared helpers of this tree (_kernel_variants.time_baseline)
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops import neighborhood_attention as na
from cosmos_predict2_tpu_torch.scripts._kernel_variants import build_variant, cuda_ms, finish, time_baseline

VARIANTS = {"stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],  # K10, K12
            "dq_stages2": [("constexpr int kDqStages = 3;", "constexpr int kDqStages = 2;")]}  # K11
NA_BASE = (-1, 44, 80)  # the geometry the sparse config's window is tuned at (natten_base_size)
# (label, (T, H, W), window, stride, dilation, K10's batch, timed calls)
CASES = [
    ("smoke", (24, 12, 20), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 2, 10),
    ("720p", (24, 44, 80), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 1, 3),
    ("480p padded", (24, 30, 52), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 1, 3),
    ("720p comb02 dilated", (24, 44, 80), (-1, 4, 16), (1, 1, 1), (1, 11, 5), 1, 5),
]
HEADS, SEED = 16, 0


def case_inputs(grid, window, stride, dilation, batch):
    """The plan, its effective window and stride, and seeded q, k, v, dO on
    the tiled layout, with out, lse and delta from K10 at batch 1."""
    size = na.VideoSize(*grid)
    w, s, d = na.adaptive_na_parameters(window, stride, grid, NA_BASE, dilation)
    ew, es = na.effective_params(size, w, s, d)
    plan = na.build_plan(size, ew, es, d)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    S = grid[0] * grid[1] * grid[2]
    q, k, v, do = (na.permute_in(torch.randn((batch, S, HEADS, 128), generator=gen, device="cuda").bfloat16(), plan)
                   for _ in range(4))
    q1, k1, v1, do1 = (t[:1].contiguous() for t in (q, k, v, do))
    out, lse = na.na_fwd(q1, k1, v1, plan, ew, es)
    return plan, ew, es, (q, k, v), (q1, k1, v1, do1, lse, na.na_delta(out, do1))


def time_tree() -> dict:
    """This checkout's K10-K12 at the cases, through its wrappers: {label: ms}."""
    times = {}
    for label, grid, window, stride, dilation, batch, iters in CASES:
        plan, ew, es, fwd_in, bwd_in = case_inputs(grid, window, stride, dilation, batch)
        times[f"K10 {label}"] = cuda_ms(lambda: na.na_fwd(*fwd_in, plan, ew, es), iters)
        times[f"K11 {label}"] = cuda_ms(lambda: na.na_bwd_dq(*bwd_in, plan, ew, es), iters)
        times[f"K12 {label}"] = cuda_ms(lambda: na.na_bwd_dkv(*bwd_in, plan, ew, es), iters)
        del fwd_in, bwd_in
        torch.cuda.empty_cache()
    return times


class Library:
    """K10-K12 through a kernel library's C entry points: the built
    library, or one compiled from a patched copy of the source."""

    def __init__(self, name: str, patches: list[tuple[str, str]] | None = None):
        self.name = name
        if patches is None:
            self.lib = _build.library()
            return
        self.lib = build_variant("neighborhood_attention.cu", name, patches,
                                 ("na_fwd_kernel", "na_bwd_dq_kernel", "na_bwd_dkv_kernel"), launch_regs=168)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.cosmos_na_fwd.argtypes = [p] * 8 + [i] * 14 + [f, p]
        self.lib.cosmos_na_bwd_dq.argtypes = [p] * 10 + [i] * 14 + [f, p]
        self.lib.cosmos_na_bwd_dkv.argtypes = [p] * 11 + [i] * 14 + [f, p]

    def k10(self, q, k, v, plan, ew, es):
        out, lse = torch.empty_like(q), torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        tabs = na.plan_tensors(plan, q.device)
        err = self.lib.cosmos_na_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                     tabs["walk"].data_ptr(), tabs["walk_counts"].data_ptr(), tabs["coords"].data_ptr(),
                                     q.shape[0], HEADS, plan.s_pad, plan.bt, plan.walk.shape[1], *plan.size, *ew, *es,
                                     128**-0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} K10")
        return out, lse

    def k11(self, q, k, v, do, lse, delta, plan, ew, es):
        dq = torch.empty_like(q)
        tabs = na.plan_tensors(plan, q.device)
        err = self.lib.cosmos_na_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                        delta.data_ptr(), dq.data_ptr(), tabs["walk"].data_ptr(),
                                        tabs["walk_counts"].data_ptr(), tabs["coords"].data_ptr(), 1, HEADS, plan.s_pad,
                                        plan.bt, plan.walk.shape[1], *plan.size, *ew, *es, 128**-0.5,
                                        torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} K11")
        return (dq,)

    def k12(self, q, k, v, do, lse, delta, plan, ew, es):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        tabs = na.plan_tensors(plan, q.device)
        err = self.lib.cosmos_na_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                         delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), tabs["walkT"].data_ptr(),
                                         tabs["walkT_counts"].data_ptr(), tabs["coords"].data_ptr(), 1, HEADS,
                                         plan.s_pad, plan.bt, plan.walkT.shape[1], *plan.size, *ew, *es, 128**-0.5,
                                         torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} K12")
        return dk, dv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another checkout whose K10-K12 to time alongside")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("na_variants: needs a CUDA card")
    built = Library("built")
    variants = [Library(name, patch) for name, patch in VARIANTS.items()]
    summary: dict = {"baseline": [], "tree": [], "variants": {}, "tflops_on_computed": {}}
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    summary["tree"].append(time_tree())
    for label, grid, window, stride, dilation, batch, iters in CASES:
        plan, ew, es, fwd_in, bwd_in = case_inputs(grid, window, stride, dilation, batch)
        pairs = na.walk_computed_pairs(plan)
        ref = {"K10": built.k10(*fwd_in, plan, ew, es), "K11": built.k11(*bwd_in, plan, ew, es),
               "K12": built.k12(*bwd_in, plan, ew, es)}
        line = []
        for kernel, call, flops in (("K10", lambda lib: lib.k10(*fwd_in, plan, ew, es), 4 * batch * pairs["na_fwd"]),
                                    ("K11", lambda lib: lib.k11(*bwd_in, plan, ew, es), 6 * pairs["na_bwd_dq"]),
                                    ("K12", lambda lib: lib.k12(*bwd_in, plan, ew, es), 8 * pairs["na_bwd_dkv"])):
            ms = cuda_ms(lambda: call(built), iters)
            rate = flops * HEADS * 128 / ms / 1e9
            summary["tflops_on_computed"][f"{kernel} {label}"] = rate
            line.append(f"{kernel} {label}: built {ms:.3f} ms ({rate:.1f} TFLOP/s on the computed pairs)")
            want = ref[kernel]
            for var in variants + variants[::-1]:  # each variant twice, in turns
                got = call(var)
                ms = cuda_ms(lambda: call(var), iters)
                summary["variants"].setdefault(var.name, {}).setdefault(f"{kernel} {label}", []).append(ms)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                line.append(f"{var.name} {ms:.3f} ms (same bits {same})")
        print(" | ".join(line), flush=True)
        del fwd_in, bwd_in, ref
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
