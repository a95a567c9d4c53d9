"""attn_bwd_roofline.train (%): the least time the window's attention
backward calls could take (counting.attention_backward_cost: four products
and one recompute of the logits) over the device time of K7 and K8."""

from port_bench.counting import calls_bound_seconds


def read(r):
    families = r.get("trace", {}).get("families", {})
    seconds = families.get("K7 flash attention dQ", 0.0) + families.get("K8 flash attention dK/dV", 0.0)
    if r["kind"] != "train" or not seconds:
        return None
    return 100.0 * calls_bound_seconds(r["attention"], "k7k8", backward=True) / seconds
