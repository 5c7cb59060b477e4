"""The decode step's host ms (``harness.readings``), in the cells whose
decode step sets the time per output token."""

from harness.readings import decode_step_ms


def read(run):
    return decode_step_ms(run.window)
