"""The MoE model's decode step in host ms (``harness.readings``), in the
cell that reports tokens/s and not the per-token tail: there the step,
over every lane at once, sets the rate."""

from harness.readings import decode_step_ms


def read(run):
    return decode_step_ms(run.window)
