"""Seconds from the process's start to the window's opening: imports, the
weights, the kernels' build or load, the pool, every graph captured, the
cache filled and the clients started."""


def read(run):
    return run.setup_s
