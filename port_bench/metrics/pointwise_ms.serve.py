"""pointwise_ms.serve (ms): device milliseconds a denoising step in PyTorch's
native elementwise, copy / cast and reduction kernels (port_bench/trace.py's
families), the DiT's non-matmul chain."""

from port_bench.trace import POINTWISE


def read(r):
    families = r.get("trace", {}).get("families")
    if r["kind"] != "serve" or not families or not r["units"]:
        return None
    return 1e3 * sum(families.get(f, 0.0) for f in POINTWISE) / r["units"]
