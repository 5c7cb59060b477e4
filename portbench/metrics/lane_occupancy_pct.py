"""Busy lanes over lanes, time-weighted over the window: after each round,
the lanes that held a request during it (those still held, and those the
round finished), weighted by the round's seconds; read from
``Scheduler.active`` between rounds. The profiler's start and stop in a traced
run, when no round runs, are left out of the window's seconds."""


def read(run):
    w = run.window
    return 100.0 * w.busy_lane_s / (w.lanes * w.active_seconds)
