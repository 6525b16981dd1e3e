"""Prompt + response tokens of every sample of the window's ``train_step``
calls (as ``train_step`` counts ``num_tokens``), over the window's seconds."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
