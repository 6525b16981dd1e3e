"""Share (%) of the traced unit in which no operation ran on the device:
1 - (union of the profiler's device intervals) / (the unit's seconds)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
