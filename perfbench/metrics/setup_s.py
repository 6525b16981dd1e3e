"""Seconds from the start of the process to the window: imports, the kernel
build (a checkout's first run), the model and trainer build, the traffic and
the followed steps that warm every shape; the check's own reading is left out."""


def read(run):
    return run.setup_s
