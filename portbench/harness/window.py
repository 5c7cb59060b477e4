"""The measured window: the mix's clients drive the engine through
``Scheduler.submit`` and ``Scheduler.round`` alone, and the harness reads
the engine's counters and its requests between rounds.

A closed loop keeps one client per lane; a client sends its next request as
soon as the harness sees its last one complete after a round. Before the
window opens, each client's first request is sent with only a seeded share
of its output left to make (``Stream.residuals``) and run until it has its
first token, so that the clients start spread over their requests' lives,
as in a loop that has run for a while. An open loop sends each request
when it is due, from ``ramp_s`` seconds before the window opens, and times
it from then.

Every time is the host's monotonic clock, which the scheduler also stamps
``t_first_token`` with. The harness stamps a completion after the round
that finished the request.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

from repro_torch.runtime.scheduler import RequestState, Scheduler

from harness.model import drain
from harness.traffic import Stream

COUNTERS = ("decode_steps", "decode_time", "prefill_tokens", "prefill_steps",
            "prefix_hit_tokens", "prefix_hits", "rounds")


@dataclasses.dataclass
class Served:
    """One request's record: its sizes and host stamps."""

    rid: int
    prompt_len: int
    shared_len: int
    output_len: int
    t_sent: float  # closed loop: when sent; open loop: when due
    t_first: float = 0.0
    t_done: float = 0.0
    out_at_open: int = 0  # tokens it had when the window opened


@dataclasses.dataclass
class Window:
    """What the window measured; the per-layer readers take it."""

    t_open: float
    t_close: float
    lanes: int
    served: dict[int, Served]
    out_at_close: dict[int, int]
    counters: dict[str, float]  # window deltas of SchedulerStats
    busy_lane_s: float
    attempted: int
    failed: int
    graphs_in_window: int
    late_s: float  # open loop: the most a request was sent after it was due
    pauses: tuple = ()  # (start, end) of the profiler's start and stop, inside the window

    @property
    def active_seconds(self) -> float:
        """The window without the profiler's start and stop, in which the
        harness runs no round."""
        return self.seconds - sum(b - a for a, b in self.pauses)

    def unpaused(self, t0: float, t1: float) -> bool:
        """Whether [t0, t1] misses every pause: a request that waited
        through the profiler's start or stop is left out of a tail."""
        return all(t1 < a or t0 > b for a, b in self.pauses)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close

    @property
    def emitted(self) -> int:
        return sum(self.out_at_close[r] - s.out_at_open for r, s in self.served.items())

    @property
    def first_tokens(self) -> list[Served]:
        return [s for s in self.served.values() if s.t_first and self.in_window(s.t_first)]

    @property
    def completed(self) -> list[Served]:
        return [s for s in self.served.values() if s.t_done and self.in_window(s.t_done)]


def _stats(sched: Scheduler) -> dict[str, float]:
    return {k: getattr(sched.stats, k) for k in COUNTERS}


class Profiled:
    """A torch.profiler session over part of the window: it starts at the
    last round that begins before ``start`` seconds after the window opens
    (a round that begins within the longest round yet of ``start``), and
    stops at the first round ``length`` seconds after it has started, or
    when the window closes; so it starts even where one round outlasts
    ``length``. ``warm`` runs a throwaway session first (in set-up), so that
    the start inside the window does not also initialise the device
    tracer."""

    def __init__(self, start: float, length: float):
        from torch.profiler import ProfilerActivity, profile

        self.start, self.length = start, length
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.state = "waiting"
        self._span = None
        self._until = 0.0
        self.pauses: list[tuple[float, float]] = []  # its start and stop, on the host clock

    @staticmethod
    def warm() -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            if torch.cuda.is_available():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def tick(self, elapsed: float, longest_round: float = 0.0) -> None:
        from torch.profiler import record_function

        if self.state == "waiting" and elapsed + longest_round >= self.start:
            t0 = time.monotonic()
            self.prof.__enter__()
            self._span = record_function("portbench.profiled")
            self._span.__enter__()
            self.state = "on"
            t1 = time.monotonic()
            self.pauses.append((t0, t1))
            self._until = t1 + self.length
        elif self.state == "on" and time.monotonic() >= self._until:
            self.stop()

    def stop(self) -> None:
        import torch

        if self.state != "on":
            return
        t0 = time.monotonic()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.pauses.append((t0, time.monotonic()))
        self.state = "done"


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def run_window(sched: Scheduler, stream: Stream, loop: str, seconds: float, *,
               ramp_s: float = 0.0, profiled: Profiled | None = None) -> Window:
    """Set up the loop's clients, then measure for ``seconds``."""
    clock, sleep = time.monotonic, time.sleep
    lanes = sched.slots
    served: dict[int, Served] = {}
    inflight: set[int] = set()
    late = [0.0]
    attempted = failed = 0
    window_open = [False]

    def send(req, t_sent: float) -> int | None:
        nonlocal attempted, failed
        if window_open[0]:
            attempted += 1
        try:
            rid = sched.submit(req.prompt, req.output_len)
        except ValueError:
            failed += int(window_open[0])
            return None
        served[rid] = Served(rid, len(req.prompt), req.shared_len, req.output_len, t_sent)
        inflight.add(rid)
        return rid

    def collect(now: float) -> list[int]:
        done = []
        for rid in list(inflight):
            r = sched.requests[rid]
            if r.t_first_token and not served[rid].t_first:
                served[rid].t_first = r.t_first_token
            if r.state is RequestState.DONE:
                served[rid].t_done = now
                inflight.discard(rid)
                done.append(rid)
        return done

    pending = None  # open loop: the next request and its absolute due time
    if loop == "closed":
        first = []
        for frac in stream.residuals(lanes):
            req = stream.next()
            req.output_len = max(1, math.ceil(req.output_len * frac))
            first.append(send(req, clock()))
        drain(sched, [r for r in first if r is not None], until=RequestState.DECODE)
        collect(clock())
        for _ in range(lanes - len(inflight)):
            send(stream.next(), clock())
    else:
        origin = clock()
        req = stream.next()
        pending = (req, origin + req.due)
        while clock() < origin + ramp_s:
            pending = _send_due(pending, stream, send, clock, late)
            if not inflight and not sched.queue:
                sleep(max(0.0, min(pending[1], origin + ramp_s) - clock()))
                continue
            sched.round()
            collect(clock())

    tracing = profiled is not None
    base = _stats(sched)
    graphs0 = len(sched.graphs)
    t_open = clock()
    window_open[0] = True
    late[0] = 0.0
    for rid in inflight:
        served[rid].out_at_open = len(sched.requests[rid].output)
    busy = longest = 0.0
    now = t_open
    while now < t_open + seconds:
        if profiled is not None:
            profiled.tick(now - t_open, longest)
        if pending is not None:
            with _span("portbench.clients", tracing):
                pending = _send_due(pending, stream, send, clock, late)
        t0 = clock()
        if not any(r is not None for r in sched.active) and not sched.queue:
            with _span("portbench.idle", tracing):
                wake = pending[1] if pending is not None else t0
                sleep(max(0.0, min(wake, t_open + seconds) - t0))
            now = clock()
            continue
        with _span("portbench.round", tracing):
            sched.round()
        now = clock()
        longest = max(longest, now - t0)
        with _span("portbench.clients", tracing):
            done = collect(now)
            held = sum(r is not None for r in sched.active) + len(done)
            busy += min(lanes, held) * (now - t0)
            if loop == "closed":
                for _ in done:
                    send(stream.next(), clock())
    if profiled is not None:
        profiled.stop()
    end = _stats(sched)
    return Window(
        t_open=t_open, t_close=now, lanes=lanes, served=served,
        out_at_close={rid: len(sched.requests[rid].output) for rid in served},
        counters={k: end[k] - base[k] for k in COUNTERS},
        busy_lane_s=busy, attempted=attempted, failed=failed,
        graphs_in_window=len(sched.graphs) - graphs0, late_s=late[0],
        pauses=tuple((max(a, t_open), min(b, now)) for a, b in profiled.pauses
                     if a < now and b > t_open) if profiled is not None else (),
    )


def _send_due(pending, stream: Stream, send, clock, late):
    """Send every request due by now; returns the next one not yet due."""
    req, due = pending
    origin = due - req.due
    now = clock()
    while due <= now:
        late[0] = max(late[0], now - due)
        send(req, due)
        req = stream.next()
        due = origin + req.due
    return req, due
