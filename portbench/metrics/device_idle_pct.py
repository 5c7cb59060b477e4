"""The share of the profiled part of the window in which no kernel, copy
or set ran on the card (torch.profiler's device events)."""


def read(run):
    t = run.trace
    if t is None or not t.window_ns:
        return None
    return 100.0 * (1.0 - t.busy_ns / t.window_ns)
