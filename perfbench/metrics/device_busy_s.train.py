"""Seconds in which an operation ran on the device during the traced unit:
the union of the profiler's device intervals. The card's own work a unit,
steadier than the host-clock rate, whose window also holds the host's gaps."""


def read(run):
    return run.trace["busy_s"] if run.trace else None
