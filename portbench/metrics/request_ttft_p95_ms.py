"""Per layer, where too few requests finish in a window for the tail to
repeat within an end-to-end bound: the p95 time to first token
(``harness.readings``), set by admission and chunked prefill between the
scheduler's rounds."""

from harness.readings import ttft_p95_ms


def read(run):
    return ttft_p95_ms(run.window)
