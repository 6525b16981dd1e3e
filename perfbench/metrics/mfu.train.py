"""Share (%) of the H100's bf16 peak (989 TFLOP/s, data sheet) that the
window's model operations make of its seconds: the operations counted by
``perfbench/work.py`` from the units' sizes (five forwards' worth a unit,
the vision tower once per unique image, no recomputation)."""

from perfbench import work


def read(run):
    if not run.units or run.window_s <= 0:
        return None
    ops = sum(work.unit_work(run.cfg["model"], u)["model_ops"] for u in run.units)
    return 100.0 * ops / (run.window_s * work.PEAK_OPS_PER_S["bf16"])
