"""na_roofline.serve (%): the least time the window's K10 calls could take,
counting the (query, key) pairs inside the windows, over their device time."""

from port_bench.counting import calls_bound_seconds


def read(r):
    seconds = r.get("trace", {}).get("families", {}).get("K10 NA forward")
    if r["kind"] != "serve" or not seconds:
        return None
    return 100.0 * calls_bound_seconds(r["attention"], "k10") / seconds
