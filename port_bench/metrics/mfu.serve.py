"""mfu.serve (%): the counted model operations of the window's denoising
steps (port_bench/counting.py: every batched-CFG DiT forward, neighbourhood
blocks by visible pairs) over the window's time, the bf16 peak and the chips."""

from port_bench.counting import PEAK_BF16_FLOPS


def read(r):
    if r["kind"] != "serve" or not r["units"]:
        return None
    return 100.0 * r["flops"] / (r["window_s"] * PEAK_BF16_FLOPS * r["chips"])
