"""k1_roofline.serve (%): the least time the window's K1 calls could take on
the chip (counting.calls_bound_seconds) over their device time in the trace."""

from port_bench.counting import calls_bound_seconds


def read(r):
    seconds = r.get("trace", {}).get("families", {}).get("K1 flash attention forward")
    if r["kind"] != "serve" or not seconds:
        return None
    return 100.0 * calls_bound_seconds(r["attention"], "k1") / seconds
