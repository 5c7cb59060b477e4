"""Per-request lifecycle spans: the latency-decomposition layer.

Port of ``repro.runtime.spans`` (plain Python, copied). ``runtime.tracker``
makes serving *round*-observable; this module makes it
*request*-observable with the same contract. A ``SpanRecorder`` rides
inside the scheduler and emits one span per lifecycle phase —

    queue          submit -> admission (head-of-line + budget wait)
    prefix_lookup  radix-cache probe at admission (zero-width; carries
                   the matched-prefix length)
    prefill        one span per prefill step (chunked prompts get one
                   span per chunk, ``tokens``/``chunk_start`` attrs)
    decode         one span per round's contiguous run of decode steps
                   a lane participated in (``steps`` attr)
    handoff        prefilled KV in flight prefill->decode engine
                   (virtual interconnect transit, ``kv_bytes`` attr)
    wait           any gap the recorder tiles between two phases (round
                   overhead, other lanes' work, import transit wait)
    requeue        a drain abort marker (``aborted: true``): the
                   request restarts cold elsewhere; spans recorded for
                   it here are excluded from decomposition

— through ``Tracker.log_spans`` as ``kind="span"`` records, interleaved
with the round records in the same JSONL file. The port's scheduler emits
queue, prefix_lookup, prefill, decode, wait, and draft and verify when it
speculates; a fleet engine (``runtime.cluster``) adds handoff, and a
drain (``Scheduler.drain``) the requeue marker.

The decomposition contract (checked by ``validate_trace``, the span
analogue of ``tracker.replay_summary``): for every completed request,
its spans tile the closed interval [t_submit, t_done] *exactly* — each
span starts at the previous span's end (float-equal: the recorder
rounds every timestamp once, at the source, to ``NDIGITS`` decimals and
derived stamps reuse the same values) — and the milestone stamps
(admit/first/done) land on span boundaries. Summing phase durations up
to the first-token boundary therefore telescopes to exactly the
submit-relative TTFT, and the remainder to the decode time.

``SLOMonitor`` folds the same per-request milestones into streaming
log-bucket histograms (TTFT submit- and admit-relative, TPOT, queue
wait) plus multi-window SLO burn rates: the fraction of requests
violating an SLO policy (any object with ``ttft``, ``tpot`` and
``target``) in a sliding window, divided by the policy's error budget
(1 - target). Burn > 1 means the window is eating budget faster than the
policy allows.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, Iterable

# one rounding, at the source: every timestamp the recorder hands out is
# rounded once to this many decimals (1 ns on the virtual clock), so any
# two stamps of the same instant are float-equal after a JSON round-trip
NDIGITS = 9

SPAN_PHASES = (
    "queue",
    "prefix_lookup",
    "prefill",
    "draft",  # speculative: drafter prefill / chain proposal
    "verify",  # speculative: batched target verification of the chain
    "decode",
    "handoff",
    "wait",
    "requeue",
)


class VirtualClock:
    """A mutable virtual-seconds clock that an owner and its recorder
    share: the owner advances it, the recorder reads the same instant."""

    __slots__ = ("t",)

    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class SpanRecorder:
    """Records one request's lifecycle as contiguous spans.

    ``clock`` is any zero-arg callable returning seconds (a
    ``VirtualClock.now``, or ``time.monotonic`` for a bare scheduler). Spans buffer in-process and ``flush`` emits
    them through ``tracker.log_spans`` (dropped when ``tracker`` is
    None, so an untracked engine pays only the bookkeeping).

    Contiguity is guaranteed *by construction*: ``mark``/``open`` tile
    the gap since the request's previous span end with an explicit
    ``wait`` span instead of leaving a hole.
    """

    def __init__(
        self,
        clock: Callable[[], float],
        *,
        tracker=None,
        engine: int | None = None,
        role: str | None = None,
    ):
        self._clock = clock
        self.tracker = tracker
        self.engine = engine
        self.role = role
        self._open: dict[int, tuple[str, float, dict]] = {}
        self._last: dict[int, float] = {}
        self._buf: list[dict] = []
        # (kind, rid, t) exact milestone stamps; ``drain_events`` hands them out
        self.events: list[tuple[str, int, float]] = []
        self.n_spans = 0

    # ---------------- time ----------------

    def now(self) -> float:
        return round(self._clock(), NDIGITS)

    @staticmethod
    def _r(t: float) -> float:
        return round(t, NDIGITS)

    # ---------------- span plumbing ----------------

    def _emit(self, rid: int, phase: str, t0: float, t1: float, attrs: dict):
        self._last[rid] = t1
        self.n_spans += 1
        if self.tracker is None:
            return
        span = {"rid": rid, "phase": phase, "t0": t0, "t1": t1}
        if self.engine is not None:
            span["engine"] = self.engine
        if self.role is not None:
            span["role"] = self.role
        span.update(attrs)
        self._buf.append(span)

    def _fill_wait(self, rid: int, t0: float) -> None:
        last = self._last.get(rid)
        if last is not None and t0 > last:
            self._emit(rid, "wait", last, t0, {})

    def mark(
        self, rid: int, phase: str, t0: float, t1: float, **attrs
    ) -> None:
        """Record a closed span, tiling any gap since the request's
        previous span with a ``wait``."""
        t0, t1 = self._r(t0), self._r(t1)
        self._fill_wait(rid, t0)
        self._emit(rid, phase, t0, t1, attrs)

    def open(self, rid: int, phase: str, t0: float | None = None, **attrs):
        t0 = self.now() if t0 is None else self._r(t0)
        self._fill_wait(rid, t0)
        self._open[rid] = (phase, t0, attrs)

    def close(self, rid: int, t1: float | None = None, **attrs) -> float:
        """Close the request's open span; returns the close time."""
        t1 = self.now() if t1 is None else self._r(t1)
        phase, t0, a = self._open.pop(rid)
        self._emit(rid, phase, t0, t1, {**a, **attrs})
        return t1

    def seed(self, rid: int, t: float) -> None:
        """Start a request's timeline at ``t`` without emitting a span
        (a decode engine seeds at the handoff payload's ready time)."""
        self._last[rid] = self._r(t)

    def abort(self, rid: int, t: float | None = None, reason: str = ""):
        """Terminate a request's timeline on this engine (drain/requeue):
        whatever was open or pending closes as an ``aborted`` span, and
        ``validate_trace`` excludes this engine's spans for the rid."""
        t = self.now() if t is None else self._r(t)
        flag = {"aborted": True, "reason": reason}
        if rid in self._open:
            phase, t0, a = self._open.pop(rid)
            self._emit(rid, phase, t0, t, {**a, **flag})
        else:
            t0 = self._last.get(rid, t)
            self._emit(rid, "requeue", t0, t, flag)
        self._last.pop(rid, None)

    def forget(self, rid: int) -> None:
        """Drop per-rid state after a terminal event (done/handoff)."""
        self._open.pop(rid, None)
        self._last.pop(rid, None)

    # ---------------- milestones ----------------

    def event(self, kind: str, rid: int, t: float | None = None) -> None:
        self.events.append(
            (kind, rid, self.now() if t is None else self._r(t))
        )

    def drain_events(self) -> list[tuple[str, int, float]]:
        out, self.events = self.events, []
        return out

    # ---------------- emission ----------------

    def flush(self) -> None:
        if self._buf:
            self.tracker.log_spans(self._buf)
            self._buf = []


# --------------------------------------------------------------------------
# decomposition: the span analogue of tracker.replay_summary
# --------------------------------------------------------------------------


def iter_span_records(records: Iterable[dict]) -> list[dict]:
    return [r for r in records if r.get("kind") == "span"]


def request_spans(records: Iterable[dict]) -> dict[int, list[dict]]:
    """Spans per rid, aborted engine-visits excluded, time-ordered.

    A drained-and-requeued request restarts cold on another engine; the
    spans it recorded on the drained engine end in an ``aborted`` marker
    and the whole (rid, engine) visit is dropped — the surviving spans
    are the request's *served* timeline (possibly spanning a prefill and
    a decode engine, joined by the handoff span).
    """
    by_visit: dict[tuple[int, int | None], list[dict]] = {}
    for s in iter_span_records(records):
        by_visit.setdefault((s["rid"], s.get("engine")), []).append(s)
    out: dict[int, list[dict]] = {}
    for (rid, _eng), spans in by_visit.items():
        if any(s.get("aborted") for s in spans):
            continue
        out.setdefault(rid, []).extend(spans)
    for spans in out.values():
        spans.sort(key=lambda s: (s["t0"], s["t1"]))
    return out


def request_events(records: Iterable[dict]) -> dict[int, dict[str, float]]:
    """Milestone stamps per rid from the metrics records' event lists
    (first "first" wins; last "admit"/"done" win — a requeued request
    re-admits, and only its final admission leads anywhere)."""
    out: dict[int, dict[str, float]] = {}
    for r in records:
        if r.get("kind", "metrics") != "metrics":
            continue
        for kind, rid, t in r.get("events", ()):
            d = out.setdefault(int(rid), {})
            if kind == "first":
                d.setdefault("first", t)
            else:
                d[kind] = t
    return out


def decompose(
    records: Iterable[dict],
) -> dict[int, dict[str, float]]:
    """Per-request phase durations (seconds) up to the done stamp."""
    out: dict[int, dict[str, float]] = {}
    for rid, spans in request_spans(records).items():
        agg: dict[str, float] = {}
        for s in spans:
            agg[s["phase"]] = agg.get(s["phase"], 0.0) + (s["t1"] - s["t0"])
        out[rid] = agg
    return out


def validate_trace(records: Iterable[dict]) -> list[str]:
    """The decomposition invariant: for every request with a ``done``
    event, its (non-aborted) spans tile [t_submit, t_done] exactly —
    each span starts float-equal at the previous one's end — the
    admit/first/done stamps land on span boundaries, and the phase
    durations telescope to submit-relative TTFT + decode time. Returns
    human-readable violations (empty == the trace decomposes exactly).
    """
    records = list(records)
    spans_by = request_spans(records)
    events_by = request_events(records)
    errors: list[str] = []
    for rid, ev in sorted(events_by.items()):
        if "done" not in ev:
            continue
        spans = spans_by.get(rid)
        if not spans:
            errors.append(f"rid {rid}: done event but no surviving spans")
            continue
        bounds = {spans[0]["t0"]}
        cursor = spans[0]["t0"]
        for s in spans:
            if s["t0"] != cursor:
                errors.append(
                    f"rid {rid}: span {s['phase']} starts at {s['t0']!r}, "
                    f"previous span ended at {cursor!r} (gap/overlap)"
                )
            cursor = s["t1"]
            bounds.add(s["t1"])
        if cursor != ev["done"]:
            errors.append(
                f"rid {rid}: spans end at {cursor!r}, done at "
                f"{ev['done']!r}"
            )
        for kind in ("admit", "first"):
            if kind in ev and ev[kind] not in bounds:
                errors.append(
                    f"rid {rid}: {kind} stamp {ev[kind]!r} is not a span "
                    "boundary"
                )
        # the telescoped check: phase sums reproduce TTFT + decode time
        t0 = spans[0]["t0"]
        if "first" in ev:
            pre = math.fsum(
                s["t1"] - s["t0"] for s in spans if s["t1"] <= ev["first"]
            )
            if abs(pre - (ev["first"] - t0)) > 1e-9:
                errors.append(
                    f"rid {rid}: sum(phase spans before first) = {pre!r} "
                    f"!= ttft {ev['first'] - t0!r}"
                )
        total = math.fsum(s["t1"] - s["t0"] for s in spans)
        if abs(total - (ev["done"] - t0)) > 1e-9:
            errors.append(
                f"rid {rid}: sum(phase spans) = {total!r} != "
                f"t_done - t_submit = {ev['done'] - t0!r}"
            )
    return errors


# --------------------------------------------------------------------------
# streaming SLO monitoring
# --------------------------------------------------------------------------


class StreamingHist:
    """Fixed-memory log-bucketed latency histogram (virtual seconds)."""

    def __init__(
        self, lo: float = 1e-7, hi: float = 1e4, per_decade: int = 8
    ):
        self.lo = lo
        n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
        self._step = math.log10(hi / lo) / (n - 1)
        self._counts = [0] * (n + 2)  # + underflow/overflow
        self.n = 0
        self._min = math.inf
        self._max = -math.inf

    def add(self, v: float) -> None:
        if v is None or math.isnan(v):
            return
        self.n += 1
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if v < self.lo:
            self._counts[0] += 1
        else:
            i = int(math.log10(v / self.lo) / self._step) + 1
            self._counts[min(i, len(self._counts) - 1)] += 1

    def _edge(self, i: int) -> float:
        return self.lo * 10 ** (i * self._step)

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-th percentile,
        clamped to the exact observed min/max."""
        if self.n == 0:
            return 0.0
        target = q / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target and c:
                hi = self._max if i >= len(self._counts) - 1 else self._edge(i)
                return min(max(hi, self._min), self._max)
        return self._max

    def summary(self) -> dict:
        return {
            "n": self.n,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "max": self._max if self.n else 0.0,
        }


class SLOMonitor:
    """Streaming request-latency histograms + multi-window burn rates.

    ``observe`` once per completed request with its virtual-time
    milestones; ``burn_rates(now)`` reports, per sliding window, the
    violation rate against ``slo`` divided by the error budget
    ``1 - slo.target`` (burn > 1.0: the window consumes error budget
    faster than the policy tolerates). With no policy the histograms
    still stream and burn rates are empty.
    """

    MAX_EVENTS = 100_000

    def __init__(self, slo=None, windows: tuple[float, ...] = (60.0, 300.0, 900.0)):
        self.slo = slo
        self.windows = tuple(windows)
        self.ttft = StreamingHist()
        self.ttft_admit = StreamingHist()
        self.tpot = StreamingHist()
        self.queue_wait = StreamingHist()
        self._events: deque[tuple[float, bool]] = deque(maxlen=self.MAX_EVENTS)
        self.observed = 0
        self.violations = 0

    def observe(
        self,
        *,
        t: float,
        ttft: float = math.nan,
        ttft_admit: float = math.nan,
        tpot: float = math.nan,
        queue_wait: float = math.nan,
    ) -> None:
        self.ttft.add(ttft)
        self.ttft_admit.add(ttft_admit)
        self.tpot.add(tpot)
        self.queue_wait.add(queue_wait)
        self.observed += 1
        if self.slo is not None:
            ok = (math.isnan(ttft) or ttft <= self.slo.ttft) and (
                math.isnan(tpot) or tpot <= self.slo.tpot
            )
            self.violations += not ok
            self._events.append((t, ok))

    def burn_rates(self, now: float) -> dict[str, float]:
        if self.slo is None or not self._events:
            return {}
        budget = max(1e-9, 1.0 - getattr(self.slo, "target", 0.9))
        out = {}
        for w in self.windows:
            tot = bad = 0
            for t, ok in reversed(self._events):
                if t < now - w:
                    break
                tot += 1
                bad += not ok
            rate = bad / tot if tot else 0.0
            out[f"burn_{int(w)}s"] = round(rate / budget, 4)
        return out

    def summary(self, now: float | None = None) -> dict:
        out = {
            "observed": self.observed,
            "ttft": {k: _r6(v) for k, v in self.ttft.summary().items()},
            "ttft_admit": {
                k: _r6(v) for k, v in self.ttft_admit.summary().items()
            },
            "tpot": {k: _r6(v) for k, v in self.tpot.summary().items()},
            "queue_wait": {
                k: _r6(v) for k, v in self.queue_wait.summary().items()
            },
        }
        if self.slo is not None:
            out["violations"] = self.violations
            if now is not None:
                out.update(self.burn_rates(now))
        return out


def _r6(v):
    return round(v, 6) if isinstance(v, float) else v
