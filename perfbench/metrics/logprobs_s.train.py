"""Seconds per unit of the old and the reference log-probs: the program's
``timing_s/old`` + ``timing_s/ref`` spans (``GRPOTrainer.train_step``),
averaged over the window's units."""


def read(run):
    ms = run.unit_metrics
    if not ms:
        return None
    return sum(m["timing_s/old"] + m.get("timing_s/ref", 0.0) for m in ms) / len(ms)
