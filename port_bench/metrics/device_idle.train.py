"""device_idle.train (%): the share of the traced window in which no kernel
ran on the device (the union of kernel intervals against the window),
averaged over the devices the trace holds."""


def read(r):
    busy = r.get("trace", {}).get("busy_s")
    if r["kind"] != "train" or busy is None or not r["window_s"]:
        return None
    return 100.0 * (1.0 - busy / r["window_s"])
