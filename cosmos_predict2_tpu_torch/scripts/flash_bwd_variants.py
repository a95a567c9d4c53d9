"""Time the flash-attention backward kernels (K7 dQ, K8 dK/dV) against
variants of their source and, optionally, another checkout's, on the card.

    python -m cosmos_predict2_tpu_torch.scripts.flash_bwd_variants [--baseline DIR] [--out FILE]

A variant is ``csrc/flash_attention_bwd.cu`` with one constant changed
(VARIANTS: K7's kv tile of 128 rows; a three-stage ring in both kernels),
compiled with the package's nvcc flags into a library of its own and
called through the same C entry points as the built kernels; its results
are compared bit for bit with the built kernels'. ``--baseline DIR`` times
the K7 and K8 of the checkout in DIR (for example the parent commit
unpacked with ``git archive``) through that checkout's own wrappers, in a
subprocess, before and after this tree's runs, on the same seeded inputs.
Shapes: B1 H16 self-attention at 5,760 tokens, cross-attention of 5,760
queries to 512 keys, and 720p (84,480 tokens). Prints one line per shape
and a JSON summary (mean ms of each kernel and library) with the card's
name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

# only names that a baseline checkout's package has too (time_tree runs
# there), and the shared helpers of this tree (_kernel_variants.time_baseline)
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
)

from cosmos_predict2_tpu_torch.scripts._kernel_variants import build_variant, cuda_ms, finish, time_baseline

VARIANTS = {
    "kv128": [("constexpr int kDqBlockKV = 64;", "constexpr int kDqBlockKV = 128;")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}
# (label, Sq, Skv, timed calls)
SHAPES = [("self 5760", 5760, 5760, 10), ("cross 5760/512", 5760, 512, 10), ("720p 84480", 84480, 84480, 1)]
HEADS, SEED = 16, 0


def inputs(sq: int, skv: int, seed: int = SEED):
    """q, k, v, do (bf16, B1 H16), the forward's lse and delta, from one seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((1, sq, HEADS, 128), generator=gen, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((1, skv, HEADS, 128), generator=gen, device="cuda").bfloat16() for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v)
    return q, k, v, do, lse, attention_delta(out, do)


class Variant:
    """The backward kernels compiled from a patched copy of their source."""

    def __init__(self, name: str, patches: list[tuple[str, str]]):
        self.name = name
        self.lib = build_variant("flash_attention_bwd.cu", name, patches, "flash_attention_bwd")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.cosmos_flash_attention_bwd_dq.argtypes = [p] * 7 + [i] * 5 + [f, p]
        self.lib.cosmos_flash_attention_bwd_dkv.argtypes = [p] * 10 + [i] * 6 + [f, p]

    def dq(self, q, k, v, do, lse, delta):
        dq = torch.empty_like(q)
        err = self.lib.cosmos_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            1, q.shape[1], k.shape[1], HEADS, 0, 128**-0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} dq")
        return dq

    def dkv(self, q, k, v, do, lse, delta):
        from cosmos_predict2_tpu_torch.ops.flash_attention import dkv_split_plan

        dk, dv = torch.empty_like(k), torch.empty_like(v)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = dkv_split_plan(q.shape[1], k.shape[1], HEADS, 1, 0, sms).splits
        parts = [torch.empty((splits, *k.shape), dtype=torch.float32, device="cuda") for _ in range(2)] \
            if splits > 1 else [None, None]
        err = self.lib.cosmos_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *(None if t is None else t.data_ptr() for t in parts), 1, q.shape[1], k.shape[1], HEADS, 0,
            splits, 128**-0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{self.name} dkv")
        return dk, dv


def time_tree() -> dict:
    """This checkout's K7 and K8 at SHAPES, through its wrappers: {label: [dq ms, dkv ms]}."""
    times = {}
    for label, sq, skv, iters in SHAPES:
        args = inputs(sq, skv)
        times[label] = [cuda_ms(lambda: flash_attention_bwd_dq(*args), iters),
                        cuda_ms(lambda: flash_attention_bwd_dkv(*args), iters)]
        del args
        torch.cuda.empty_cache()
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another checkout whose K7 and K8 to time alongside")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: needs a CUDA card")
    _build.library()
    variants = [Variant(name, patches) for name, patches in VARIANTS.items()]
    summary: dict = {"baseline": [], "tree": [], "variants": {v.name: {} for v in variants}, "library": {}}
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    summary["tree"].append(time_tree())
    for label, sq, skv, iters in SHAPES:
        q, k, v, do, lse, delta = args_ = inputs(sq, skv)
        built = (flash_attention_bwd_dq(*args_), *flash_attention_bwd_dkv(*args_))
        line = [label]
        for var in variants + variants[::-1]:  # each variant twice, in turns
            got = (var.dq(*args_), *var.dkv(*args_))
            same = all(torch.equal(a, b) for a, b in zip(got, built))
            times = summary["variants"][var.name].setdefault(label, [])
            times.append([cuda_ms(lambda: var.dq(*args_), iters), cuda_ms(lambda: var.dkv(*args_), iters)])
            line.append(f"{var.name} K7 {times[-1][0]:.3f} K8 {times[-1][1]:.3f} ms (same bits {same})")
        leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        sd_out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        dot = do.transpose(1, 2)
        summary["library"][label] = cuda_ms(lambda: torch.autograd.grad(sd_out, leaves, dot, retain_graph=True), iters)
        print(" | ".join(line) + f" | SDPA backward {summary['library'][label]:.3f} ms", flush=True)
        del q, k, v, do, lse, delta, args_, built, leaves, sd_out, dot
        torch.cuda.empty_cache()
    summary["tree"].append(time_tree())
    if args.baseline:
        summary["baseline"].append(time_baseline(__file__, args.baseline))
    for who in ("tree", "baseline"):
        for run in summary[who]:
            print(who, " ".join(f"{label}: K7 {t[0]:.3f} K8 {t[1]:.3f}" for label, t in run.items()), flush=True)
    finish(summary, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
