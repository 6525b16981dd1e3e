"""Seconds per unit of the actor update: the program's
``timing_s/update_actor`` span, which ends in a device synchronisation,
averaged over the window's units."""


def read(run):
    ms = run.unit_metrics
    return sum(m["timing_s/update_actor"] for m in ms) / len(ms) if ms else None
