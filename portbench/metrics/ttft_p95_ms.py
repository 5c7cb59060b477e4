"""End to end: the p95 time to first token (``harness.readings``)."""

from harness.readings import ttft_p95_ms


def read(run):
    return ttft_p95_ms(run.window)
