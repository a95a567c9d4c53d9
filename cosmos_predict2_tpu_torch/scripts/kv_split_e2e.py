"""End-to-end effect of K5's split-KV route (flash-decoding) on the
interactive streaming path.

    python -m cosmos_predict2_tpu_torch.scripts.kv_split_e2e [--out FILE]

The plan splits where a frame block gives K5 few CTAs over a long cache:
one-frame blocks at 720p (``interactive_latency --hw 88 160
--cache-frames 8``) from a fill of two frames on, and two-frame blocks at
352x640 (``interactive_latency --frames-per-block 2``) only at the full
18-frame cache; one-frame blocks at 352x640 never split. For each of the
two, ``interactive_latency.measure`` runs with ``kv_cache_split_plan`` as
it is and with every K5 call held to one split, in the order plan, one,
one, plan, twice, timing 6 blocks each, on the same seeded weights and
noise.
Prints the p50 block latencies, the split counts the plan gave K5's calls,
and a JSON summary with the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import sys

import torch

from cosmos_predict2_tpu_torch.ops import flash_attention as fa
from cosmos_predict2_tpu_torch.scripts._kernel_variants import finish
from cosmos_predict2_tpu_torch.scripts.interactive_latency import measure

# (label, latent h w, cache frames, frames per block)
CASES = [("352x640 two-frame blocks", (44, 80), 16, 2), ("720p one-frame blocks", (88, 160), 8, 1)]
ORDER = ("plan", "one split", "one split", "plan") * 2
BLOCKS = 6


def run(hw, cache_frames: int, nb: int, one_split: bool) -> dict:
    """measure() with the plan, or with every K5 call at one split: its
    p50 block latency and the K5 calls by split count."""
    plan = fa.kv_cache_split_plan
    counts: collections.Counter = collections.Counter()

    def counted(sq, kv_valid, heads, batch, sms):
        chosen = fa.KvCachePlan(kv_valid, 1) if one_split else plan(sq, kv_valid, heads, batch, sms)
        counts[chosen.splits] += 1
        return chosen

    fa.kv_cache_split_plan = counted
    try:
        res = measure(hw, BLOCKS, cache_frames, frames_per_block=nb)
    finally:
        fa.kv_cache_split_plan = plan
    torch.cuda.empty_cache()
    return {"p50_ms": res["p50_s"] * 1e3, "laps_ms": [t * 1e3 for t in res["laps"]],
            "k5_calls_by_splits": dict(sorted(counts.items()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kv_split_e2e: needs a CUDA card")
    summary: dict = {}
    for label, hw, cache_frames, nb in CASES:
        runs = {"plan": [], "one split": []}
        for who in ORDER:
            runs[who].append(run(hw, cache_frames, nb, who == "one split"))
        summary[label] = runs
        print(f"[kv_split_e2e] {label}: p50 ms plan "
              f"{[round(r['p50_ms'], 1) for r in runs['plan']]} one split "
              f"{[round(r['p50_ms'], 1) for r in runs['one split']]}; K5 calls by splits (plan) "
              f"{runs['plan'][0]['k5_calls_by_splits']}", flush=True)
    finish(summary, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
