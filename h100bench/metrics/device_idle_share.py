"""Share of the window in which no operation ran on the device (the
profiler trace's union of kernels, copies and sets)."""

LAYER = "device"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    t = obs.trace
    if not t or t.get("busy_s") is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
