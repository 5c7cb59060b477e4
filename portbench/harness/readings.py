"""Readings of the window that more than one metric's reader reports:
the request tails (end to end in some cells, per layer in others) and the
decode step's host time."""

import numpy as np


def ttft_p95_ms(window) -> float | None:
    """p95, over every request whose first token came inside the window,
    of the time from its send (closed loop) or due time (open loop) to the
    scheduler's first-token stamp, in ms. In a traced run, requests that
    waited through the profiler's start or stop are left out."""
    t = [(s.t_first - s.t_sent) * 1e3 for s in window.first_tokens
         if window.unpaused(s.t_sent, s.t_first)]
    return float(np.percentile(t, 95)) if t else None


def tpot_p95_ms(window) -> float | None:
    """p95, over every request completed inside the window, of (completion
    - first token) / (tokens - 1), in ms; the completion is the harness's
    stamp after the round that finished it. In a traced run, requests that
    decoded through the profiler's start or stop are left out."""
    t = [(s.t_done - s.t_first) / (s.output_len - 1) * 1e3
         for s in window.completed if s.output_len > 1 and window.unpaused(s.t_first, s.t_done)]
    return float(np.percentile(t, 95)) if t else None


def tpot_top(window, n: int = 24) -> list[list[float]]:
    """The ``n`` longest times per output token of the requests that
    ``tpot_p95_ms`` reads, each as [ms, output tokens, tokens made before
    the window opened], longest first: what sets the tail."""
    t = sorted(((s.t_done - s.t_first) / (s.output_len - 1) * 1e3, s.output_len, s.out_at_open)
               for s in window.completed
               if s.output_len > 1 and window.unpaused(s.t_first, s.t_done))
    return [[ms, n_out, before] for ms, n_out, before in t[::-1][:n]]


def decode_step_ms(window) -> float | None:
    """Host ms a decode step, from its inputs to its tokens sampled: window
    deltas of ``SchedulerStats.decode_time`` over decode steps."""
    c = window.counters
    return 1e3 * c["decode_time"] / c["decode_steps"] if c["decode_steps"] else None
