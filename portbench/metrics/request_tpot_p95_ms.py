"""Per layer, where too few requests finish in a window for the tail to
repeat within an end-to-end bound: the p95 time per output token
(``harness.readings``), set by the decode step and the prefills between
decode steps."""

from harness.readings import tpot_p95_ms


def read(run):
    return tpot_p95_ms(run.window)
