"""mfu.train (%): the DiT's counted forward and backward operations of the
window's iterations (3 forwards an iteration; remat's recompute not
counted) over the window's time, the bf16 peak and the chips."""

from port_bench.counting import PEAK_BF16_FLOPS


def read(r):
    if r["kind"] != "train" or not r["units"]:
        return None
    return 100.0 * r["flops"] / (r["window_s"] * PEAK_BF16_FLOPS * r["chips"])
