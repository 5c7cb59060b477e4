"""End to end: the p95 time per output token (``harness.readings``)."""

from harness.readings import tpot_p95_ms


def read(run):
    return tpot_p95_ms(run.window)
