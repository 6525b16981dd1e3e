"""Share (%) of the least time the flash kernels (#1-#3: ``flash_*`` in the
device trace) could take for the attention the traced unit's sequences need,
counted by ``perfbench/work.py`` from the unit's sizes, of the time they
took. Nothing to read without a trace or without a flash kernel in it."""

from perfbench import trace, work


def read(run):
    if not run.trace or run.traced_unit is None:
        return None
    spent = trace.kernel_seconds(run.trace, "flash_")
    if spent <= 0:
        return None
    w = work.unit_work(run.cfg["model"], run.traced_unit)
    return 100.0 * work.bound_s(w["attention_bytes"], w["attention_ops"]) / spent
