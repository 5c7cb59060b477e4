"""Fleet router: policy-driven dispatch over N engine replicas. Port of
``repro.runtime.cluster.router``.

The router owns the fleet's intake queue and dispatches arrivals to
engines under one of three policies:

  * ``least-loaded``: the engine with the fewest committed + queued
    tokens that can take the request's *full* token commitment (a request
    is never parked on an engine whose budget cannot hold it, so one hot
    engine cannot hoard the queue while others idle);
  * ``affinity``: requests of one session stick to the engine that served
    the session before (falling back to least-loaded when that engine is
    full or drained, and re-pinning), which is what makes prefix reuse
    possible at all;
  * ``prefix-aware``: engines are scored by how many of the prompt's
    tokens their radix prefix cache already holds, the pinned engine's
    match counting double; with no cached prefix anywhere the policy is
    affinity, then least-loaded.

Dispatch is FIFO: the head of the backlog waits until some engine can
accept it (no starvation, deterministic order). ``drain_engine`` stops
an engine's intake and requeues its not-yet-decoding requests at the
front of the backlog; in-flight requests finish where they are. Sampling
is keyed on the fleet-wide request id, so a requeued request gives its
exact token stream on the new engine.

``FleetCluster`` runs the shared virtual-time event loop (see
``cluster.engine``): engines advance clocks of their own, the loop always
steps the furthest-behind busy engine, and arrivals are delivered in
virtual-time order: a deterministic discrete-event simulation whose
per-token work is the real model.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

from repro_torch.models.config import CHUNKABLE_FAMILIES, ModelConfig
from repro_torch.models.lm import SamplingParams
from repro_torch.runtime.cluster.engine import Engine, StepCostModel
from repro_torch.runtime.spans import SLOMonitor
from repro_torch.runtime.cluster.traffic import (
    ClientRequest,
    RequestTiming,
    SloPolicy,
    SloReport,
    slo_report,
)
from repro_torch.runtime.scheduler import RequestState


class Router:
    """Global intake queue + engine-selection policy."""

    POLICIES = ("least-loaded", "affinity", "prefix-aware")

    def __init__(self, engines: list[Engine], policy: str = "least-loaded"):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; valid: {self.POLICIES}"
            )
        self.engines = engines
        self.policy = policy
        self.backlog: deque[ClientRequest] = deque()
        self.affinity: dict[int, int] = {}  # session -> engine_id
        # rid -> engine ids it was queued on (len > 1 after a drain move)
        self.assignments: dict[int, list[int]] = {}

    def _fits_somewhere(self, creq: ClientRequest) -> bool:
        """Whether some undrained engine could *ever* hold this request.

        A chunkable family's engine is not bounded by its admission token
        budget (the scheduler admits an over-budget prompt solo and
        streams it through budget-sized chunks), so only the pool capacity
        and ``max_len`` are hard walls."""
        def ceiling(e: Engine) -> int:
            cap = min(
                e.scheduler.max_len,
                e.scheduler.pool.usable_blocks
                * e.scheduler.pool.block_tokens,
            )
            if e.cfg.family not in CHUNKABLE_FAMILIES:
                cap = min(cap, e.scheduler.token_budget)
            return cap

        return any(
            not e.drained and creq.total_tokens <= ceiling(e)
            for e in self.engines
        )

    def offer(self, creq: ClientRequest) -> None:
        if not self._fits_somewhere(creq):
            raise ValueError(
                f"request {creq.rid} needs {creq.total_tokens} tokens; no "
                "undrained engine can ever hold it"
            )
        self.backlog.append(creq)

    def requeue(self, creqs: list[ClientRequest]) -> None:
        """Put drained requests back at the front, preserving order."""
        self.backlog.extendleft(reversed(creqs))

    def _pick(self, creq: ClientRequest) -> Engine | None:
        cands = [e for e in self.engines if e.can_accept(creq.total_tokens)]
        if not cands:
            return None
        if self.policy in ("affinity", "prefix-aware"):
            pinned = self.affinity.get(creq.session)
            if self.policy == "prefix-aware":
                # matched-prefix length x session affinity: the pinned
                # engine's cached tokens weigh double
                scored = [
                    (
                        e.prefix_match_tokens(creq.prompt)
                        * (2 if e.engine_id == pinned else 1),
                        e,
                    )
                    for e in cands
                ]
                best = max(s for s, _ in scored)
                if best > 0:
                    return min(
                        (e for s, e in scored if s == best),
                        key=lambda e: (e.load_tokens, e.engine_id),
                    )
            for e in cands:
                if e.engine_id == pinned:
                    return e
        return min(cands, key=lambda e: (e.load_tokens, e.engine_id))

    def dispatch(self) -> int:
        """Move backlog head(s) onto engines; returns dispatched count."""
        n = 0
        while self.backlog:
            creq = self.backlog[0]
            engine = self._pick(creq)
            if engine is None:
                break  # FIFO: head-of-line waits for budget to free
            self.backlog.popleft()
            if not engine.has_work():
                # an idle engine cannot have started before the arrival
                engine.clock = max(engine.clock, creq.t_arrival)
            # queue wait is measured from the client arrival (also after
            # a drain/requeue: the request's clock never restarts)
            engine.submit(
                creq.prompt,
                creq.max_new_tokens,
                creq.rid,
                t_submit=creq.t_arrival,
            )
            self.affinity[creq.session] = engine.engine_id
            self.assignments.setdefault(creq.rid, []).append(
                engine.engine_id
            )
            n += 1
        return n


@dataclasses.dataclass
class FleetRunResult:
    """Outputs + virtual-time telemetry of one cluster run."""

    outputs: dict[int, list[int]]
    timings: dict[int, RequestTiming]
    engine_summaries: list[dict]
    assignments: dict[int, list[int]]
    # fleet-level SLOMonitor.summary(): streaming TTFT/TPOT/queue-wait
    # histograms and multi-window burn rates (empty without completions)
    slo_summary: dict = dataclasses.field(default_factory=dict)
    # fleet-level memory-pressure view (memledger.MemPressureMonitor):
    # worst per-engine signal, peak occupancy, eviction churn
    mem_summary: dict = dataclasses.field(default_factory=dict)

    def report(self, slo: SloPolicy) -> SloReport:
        return slo_report(self.timings, slo)


class FleetCluster:
    """N identical serve engines (prefill and decode each) behind a
    router. ``compiled`` goes to every engine's scheduler."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_engines: int,
        slots: int,
        max_len: int,
        block_tokens: int,
        cost: StepCostModel,
        policy: str = "least-loaded",
        token_budget: int | None = None,
        sampling: SamplingParams | None = None,
        prefix_cache: bool = False,
        speculative=None,
        tracker=None,
        trace_spans: bool = True,
        slo: SloPolicy | None = None,
        mem_policy=None,
        compiled: bool | None = None,
    ):
        self.cfg = cfg
        self.tracker = tracker
        self.slo = slo
        self.engines = [
            Engine(
                i,
                cfg,
                params,
                slots=slots,
                max_len=max_len,
                block_tokens=block_tokens,
                cost=cost,
                role="both",
                token_budget=token_budget,
                sampling=sampling,
                prefix_cache=prefix_cache,
                speculative=speculative,
                tracker=tracker,
                trace_spans=trace_spans,
                slo=slo,
                mem_policy=mem_policy,
                compiled=compiled,
            )
            for i in range(n_engines)
        ]
        self.router = Router(self.engines, policy)
        self.timings: dict[int, RequestTiming] = {}
        self._by_rid: dict[int, ClientRequest] = {}
        # fleet-level streaming SLO view, fed from completion events with
        # full (submit, admit, first, done) milestones: the cross-engine
        # complement of each engine's own monitor
        self.slo_monitor = SLOMonitor(slo)

    # hooks the disaggregated subclass specialises -----------------------

    def _route_payloads(self) -> None:
        return None  # no prefill->decode traffic in a symmetric fleet

    def _in_flight(self) -> bool:
        return False

    # --------------------------------------------------------------------

    def drain_engine(self, engine_id: int) -> list[int]:
        """Stop an engine's intake; requeue its queued requests. Returns
        the moved request ids."""
        engine = next(
            e for e in self.engines if e.engine_id == engine_id
        )
        moved = engine.drain()
        self.router.requeue([self._by_rid[r.rid] for r in moved])
        return [r.rid for r in moved]

    def restore_engine(self, engine_id: int) -> None:
        """Reopen a drained engine's intake (it cycles out and back without
        being rebuilt, its cache intact)."""
        next(
            e for e in self.engines if e.engine_id == engine_id
        ).undrain()

    def _absorb_events(self, engine: Engine) -> None:
        for kind, rid, t in engine.events:
            timing = self.timings[rid]
            if kind == "admit":
                # last admission wins: a drained-and-requeued request
                # re-admits elsewhere, and only that one leads anywhere
                timing.t_admit = t
            elif kind == "first" and math.isnan(timing.t_first):
                timing.t_first = t
            elif kind == "done":
                timing.t_done = t
                req = engine.scheduler.requests.get(rid)
                n = len(req.output) if req is not None else 0
                self.slo_monitor.observe(
                    t=t,
                    ttft=timing.ttft,
                    ttft_admit=timing.ttft_admit,
                    tpot=(t - timing.t_first) / (n - 1) if n > 1 else 0.0,
                    queue_wait=timing.queue_wait,
                )
        engine.events.clear()

    def run(
        self,
        trace: list[ClientRequest],
        *,
        drain_at: tuple[int, float] | None = None,
        max_rounds: int | None = None,
        round_hook=None,
    ) -> FleetRunResult:
        """Serve the trace to completion on the virtual clock.

        ``drain_at`` (engine id, virtual time) drains that engine at the
        first event at or after that time. ``round_hook(engine,
        round_index)``, when given, runs after every engine round (a
        periodic invariant probe: pool ``validate()``, leak checks)."""
        pending = deque(
            sorted(trace, key=lambda r: (r.t_arrival, r.rid))
        )
        # arrivals rounded like every span/event stamp (spans.NDIGITS),
        # so queue_wait = t_admit - t_arrival can never go dust-negative
        self.timings = {
            r.rid: RequestTiming(r.rid, round(r.t_arrival, 9))
            for r in trace
        }
        self._by_rid = {r.rid: r for r in trace}
        limit = max_rounds or 64 + 4 * sum(
            r.total_tokens for r in trace
        )
        rounds = 0
        drain_pending = drain_at
        while True:
            busy = [e for e in self.engines if e.has_work()]
            t_round = min((e.clock for e in busy), default=math.inf)
            t_arr = pending[0].t_arrival if pending else math.inf
            t_evt = min(t_round, t_arr)
            if drain_pending is not None and t_evt >= drain_pending[1]:
                self.drain_engine(drain_pending[0])
                drain_pending = None
            while pending and pending[0].t_arrival <= t_evt:
                self.router.offer(pending.popleft())
            self.router.dispatch()
            self._route_payloads()
            busy = [e for e in self.engines if e.has_work()]
            if not busy:
                if pending:
                    continue  # next iteration jumps to the arrival
                if self.router.backlog or self._in_flight():
                    raise RuntimeError(
                        f"cluster stuck: {len(self.router.backlog)} "
                        "backlogged requests and no engine can accept"
                    )
                break
            engine = min(busy, key=lambda e: (e.clock, e.engine_id))
            engine.step_round()
            self._absorb_events(engine)
            rounds += 1
            if round_hook is not None:
                round_hook(engine, rounds)
            if rounds > limit:
                raise RuntimeError(
                    f"cluster failed to drain after {rounds} rounds"
                )
        return self._finish()

    def _finish(self) -> FleetRunResult:
        outputs: dict[int, list[int]] = {}
        for e in self.engines:
            e.scheduler.pool.validate()
            e.spans.flush()  # drained engines may hold buffered aborts
            # a drain after the last emitted round leaves release records
            # buffered; sync + flush keeps the mem stream complete
            e.ledger.sync()
            e.ledger.flush()
            for rid, req in e.scheduler.requests.items():
                if req.state is RequestState.HANDOFF:
                    continue  # finished on a decode engine
                if rid in outputs:
                    raise AssertionError(
                        f"request {rid} completed on two engines"
                    )
                outputs[rid] = req.output
        for rid, timing in self.timings.items():
            timing.n_tokens = len(outputs.get(rid, ()))
        clock = max((e.clock for e in self.engines), default=0.0)
        mems = {
            e.engine_id: e.mem_monitor.summary(now=e.clock)
            for e in self.engines
        }
        sig_rank = {"ok": 0, "pressure": 1, "storm": 2}
        mem_summary = {
            "peak_occupancy": max(
                (m["peak_occupancy"] for m in mems.values()), default=0.0
            ),
            "evicted_blocks": sum(m["evicted_blocks"] for m in mems.values()),
            "headroom_blocks": min(
                (m["headroom_blocks"] for m in mems.values()), default=0
            ),
            "signal": max(
                (m.get("signal", "ok") for m in mems.values()),
                key=lambda s: sig_rank.get(s, 0),
                default="ok",
            ),
            "pressure_engines": sorted(
                eid
                for eid, m in mems.items()
                if m.get("signal", "ok") != "ok"
            ),
        }
        return FleetRunResult(
            outputs=outputs,
            timings=self.timings,
            engine_summaries=[e.summary() for e in self.engines],
            assignments=dict(self.router.assignments),
            slo_summary=self.slo_monitor.summary(now=clock),
            mem_summary=mem_summary,
        )
