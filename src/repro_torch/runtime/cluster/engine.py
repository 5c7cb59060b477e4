"""One fleet engine replica: a ``runtime.scheduler.Scheduler`` and its KV
pool behind a virtual clock. Port of ``repro.runtime.cluster.engine``.

Real tokens, virtual seconds. Every engine runs the model on the device
of the parameters it is given (its token streams are the single-engine
ones), but *time* is charged from a roofline ``StepCostModel``, so N
engines overlap in virtual time in one process and a trace replays
deterministically. The cost model is calibrated from a (usually
full-size) ``ModelConfig`` against ``perf.roofline.HW``, the H100 SXM's
data-sheet figures: decode steps are HBM-bound (weight re-reads), prefill
is tensor-core-bound per token plus one weight sweep per step, and a
prefill-to-decode handoff pays the KV payload over NVLink. Every time on
this clock is modelled, not measured.

All engines of a fleet share one copy of the weights: an engine neither
copies nor packs them. Each builds its own pool, on the parameters'
device, its own scheduler (with its own CUDA graphs on the card) and, when
speculating, its own drafter.
"""

from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

from repro_torch.models.config import (
    CHUNKABLE_FAMILIES,
    PACKING_FAMILIES,
    ModelConfig,
    torch_dtype,
)
from repro_torch.models.lm import SamplingParams
from repro_torch.perf.roofline import HW, HwModel
from repro_torch.runtime.kv_pool import KVPool
from repro_torch.runtime.memledger import MemLedger, MemPressureMonitor
from repro_torch.runtime.scheduler import PrefillHandoff, Scheduler
from repro_torch.runtime.spans import SLOMonitor, SpanRecorder, VirtualClock


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Virtual-seconds cost of the scheduler's unit operations."""

    prefill_s_per_token: float  # tensor-core term: 2 * N_active flops / peak
    prefill_s_per_step: float  # one weight sweep HBM -> compute per step
    decode_s_per_step: float  # one batched decode step (all lanes)
    handoff_s_per_token: float  # K/V rows over the link
    round_overhead_s: float = 1e-6  # host bookkeeping per round

    @classmethod
    def for_config(
        cls, cfg: ModelConfig, *, slots: int, hw: HwModel = HW
    ) -> "StepCostModel":
        """Calibrate from a model config (typically the *full-size* arch:
        a fleet may serve a smoke config's tokens while charging the
        production arch's time)."""
        n_active = cfg.active_params()
        dt_bytes = torch_dtype(cfg).itemsize
        weight_bytes = n_active * dt_bytes
        if cfg.w_bits in (1, 2) and cfg.family in PACKING_FAMILIES:
            # FCMP packing shrinks the dense-FFN re-read traffic (hybrid
            # has one shared FFN copy, encdec packs both stacks, the rest
            # one per layer)
            if cfg.family == "hybrid":
                copies = 1
            elif cfg.family == "encdec":
                copies = cfg.n_layers + cfg.n_enc_layers
            else:
                copies = cfg.n_layers
            ffn = 3 * cfg.d_model * cfg.d_ff * copies * dt_bytes
            weight_bytes = weight_bytes - ffn + ffn * cfg.w_bits // (8 * dt_bytes)
        flops_per_token = 2.0 * n_active
        kv_bytes_per_token = cfg.n_kv_cache_layers * 2 * cfg.n_kv * cfg.hd * dt_bytes
        return cls(
            prefill_s_per_token=flops_per_token / hw.peak_flops,
            prefill_s_per_step=weight_bytes / hw.hbm_bw,
            decode_s_per_step=max(
                weight_bytes / hw.hbm_bw, flops_per_token * slots / hw.peak_flops
            ),
            handoff_s_per_token=kv_bytes_per_token / hw.ici_bw,
        )

    def prefill_rate(self, mean_prompt: float) -> float:
        """Sustained prefill tokens/s at the given mean prompt length."""
        per_req = mean_prompt * self.prefill_s_per_token + self.prefill_s_per_step
        return mean_prompt / per_req

    def decode_rate(self, slots: int) -> float:
        """Sustained decode tokens/s with every lane busy."""
        return slots / self.decode_s_per_step


class Engine:
    """A scheduler replica with a virtual clock and handoff plumbing.

    Roles: ``both`` (a full serve engine), ``prefill`` (admission and
    prefill only; finished prompts leave through the scheduler's handoff
    hook as ``PrefillHandoff`` payloads in ``outbox``; it never runs a
    decode step, so it never captures a decode graph), ``decode`` (adopts
    payloads from ``offer_import`` and runs their decode lanes; it never
    prefills, so it captures no prefill graph). ``compiled`` goes to the
    scheduler (None: CUDA graphs on a CUDA pool).
    """

    def __init__(
        self,
        engine_id: int,
        cfg: ModelConfig,
        params,
        *,
        slots: int,
        max_len: int,
        block_tokens: int,
        cost: StepCostModel,
        role: str = "both",
        token_budget: int | None = None,
        sampling: SamplingParams | None = None,
        prefix_cache: bool = False,
        speculative=None,
        tracker=None,
        trace_spans: bool = True,
        slo=None,
        mem_policy=None,
        compiled: bool | None = None,
    ):
        assert role in ("both", "prefill", "decode"), role
        self.engine_id = engine_id
        self.cfg = cfg
        self.role = role
        self.cost = cost
        # the engine, its span recorder, its ledger and the scheduler's
        # charge hook share one clock, so mid-round work is stamped at the
        # instant it is charged
        self._vclock = VirtualClock()
        self.drained = False
        self.tracker = tracker
        self.spans = SpanRecorder(
            self._vclock.now,
            tracker=tracker if trace_spans else None,
            engine=engine_id,
            role=role,
        )
        # streaming TTFT/TPOT/queue-wait histograms and burn rates against
        # ``slo`` (``traffic.SloPolicy``; None: histograms only)
        self.slo_monitor = SLOMonitor(slo)
        self._marks: dict[int, dict[str, float]] = {}
        pool = KVPool.for_slots(
            cfg, slots=slots, max_len=max_len, block_tokens=block_tokens,
            device=params["embed"].device,
        )
        cache = None
        if prefix_cache:
            from repro_torch.runtime.prefix_cache import PrefixCache

            cache = PrefixCache(pool)
        # the memory ledger emits kind="mem" pool-mutation deltas on the
        # same virtual clock and tracker stream; the pressure monitor turns
        # the per-round gauges into an admission / scale signal
        self.ledger = MemLedger(self._vclock.now, tracker=tracker, engine=engine_id, role=role)
        self.mem_monitor = MemPressureMonitor(mem_policy)
        # speculative decoding (runtime.speculative.ResolvedSpec): each
        # engine builds its own drafter (private lane KV), charged at its
        # own roofline (a packed twin pays its discounted weight sweep,
        # ngram nothing); a verify step pays one target weight sweep plus
        # the chain's extra tokens
        self.draft_cost: StepCostModel | None = None
        spec = None
        if speculative is not None and role != "prefill":
            spec = speculative.build(cfg, params, slots=slots, max_len=max_len)
            if speculative.draft_full_cfg is not None:
                self.draft_cost = StepCostModel.for_config(
                    speculative.draft_full_cfg, slots=slots
                )
        self.scheduler = Scheduler(
            cfg,
            params,
            pool,
            slots=slots,
            max_len=max_len,
            token_budget=token_budget,
            sampling=sampling,
            compiled=compiled,
            handoff=self._on_handoff if role == "prefill" else None,
            prefix_cache=cache,
            speculative=spec,
            spans=self.spans,
            ledger=self.ledger,
            mem_monitor=self.mem_monitor,
        )
        # every prefill / decode step advances the clock as it runs, so
        # span boundaries and the round record's clock_s share one account
        self.scheduler.charge = self._charge_work
        # the scheduler's round record comes through here, to be logged
        # with the post-round virtual clock and this engine's identity
        self._pending_records: list[dict] = []
        if tracker is not None:
            self.scheduler.on_round = self._pending_records.append
            tracker.log_hyperparameters(
                {
                    "surface": "engine",
                    "engine": engine_id,
                    "role": role,
                    "arch": cfg.name,
                    "family": cfg.family,
                    "slots": slots,
                    "max_len": max_len,
                    "block_tokens": block_tokens,
                    "token_budget": self.scheduler.token_budget,
                    "prefix_cache": prefix_cache,
                    "decode_s_per_step": cost.decode_s_per_step,
                    "prefill_s_per_token": cost.prefill_s_per_token,
                }
            )
        self.outbox: list[tuple[float, PrefillHandoff]] = []
        self._imports: list[tuple[float, int]] = []  # (ready_at, rid)
        self._import_payloads: dict[int, PrefillHandoff] = {}
        self._import_tokens = 0
        # (kind, rid, t) with kind in {"admit", "first", "done",
        # "handoff"}; stamped by the span recorder, drained by the cluster
        self.events: list[tuple[str, int, float]] = []

    # ---------------- virtual clock ----------------

    @property
    def clock(self) -> float:
        return self._vclock.t

    @clock.setter
    def clock(self, t: float) -> None:
        # the router's arrival alignment and the import waits write here;
        # the shared clock makes them visible to the recorder and the hook
        self._vclock.t = t

    def _charge_work(self, op: str, *, tokens: int = 0, steps: int = 0):
        if op == "prefill":
            self._vclock.advance(
                tokens * self.cost.prefill_s_per_token + steps * self.cost.prefill_s_per_step
            )
        elif op == "decode":
            self._vclock.advance(steps * self.cost.decode_s_per_step)
        elif op == "draft":
            # the drafter's own roofline: a prompt prefill carries tokens,
            # a rollout only steps; an ngram drafter has no cost model
            dc = self.draft_cost
            if dc is not None:
                if tokens:
                    self._vclock.advance(
                        tokens * dc.prefill_s_per_token + steps * dc.prefill_s_per_step
                    )
                else:
                    self._vclock.advance(steps * dc.decode_s_per_step)
        elif op == "verify":
            # one target weight sweep scores the whole chain; ``tokens``
            # are the positions beyond one a lane, at the prefill rate
            self._vclock.advance(
                steps * self.cost.decode_s_per_step + tokens * self.cost.prefill_s_per_token
            )
        else:  # pragma: no cover - the scheduler charges only these ops
            raise ValueError(f"unknown charge op {op!r}")

    # ---------------- load / admission ----------------

    @property
    def queued_tokens(self) -> int:
        return sum(r.total_tokens for r in self.scheduler.queue) + self._import_tokens

    @property
    def load_tokens(self) -> int:
        """Committed, queued and pending-import tokens: the router's
        least-loaded metric."""
        return self.scheduler.committed_tokens + self.queued_tokens

    def can_accept(self, total_tokens: int) -> bool:
        if self.drained:
            return False
        sched = self.scheduler
        usable = sched.pool.usable_blocks * sched.pool.block_tokens
        if total_tokens > min(usable, sched.max_len):
            return False
        if self.load_tokens + total_tokens <= sched.token_budget:
            return True
        # fleet-level chunked admission: an over-budget prompt lands on an
        # *idle* engine of a chunkable family, which admits it solo and
        # streams it through budget-sized chunks
        return self.cfg.family in CHUNKABLE_FAMILIES and self.load_tokens == 0

    def prefix_match_tokens(self, prompt) -> int:
        """Longest cached-prefix match for a prompt on this engine (0
        without a cache): the prefix-aware router's score."""
        cache = self.scheduler.prefix_cache
        if cache is None:
            return 0
        return cache.match_tokens(prompt, anchor=(self.cfg.family == "hybrid"))

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        rid: int,
        t_submit: float | None = None,
    ):
        t_sub = self.clock if t_submit is None else t_submit
        self._marks[rid] = {"submit": t_sub}
        self.scheduler.submit(prompt, max_new_tokens, rid=rid, t_submit=t_sub)

    def offer_import(self, ready_at: float, payload: PrefillHandoff) -> None:
        bisect.insort(self._imports, (ready_at, payload.rid))
        self._import_payloads[payload.rid] = payload
        self._import_tokens += payload.total_tokens

    def has_work(self) -> bool:
        return bool(
            self.scheduler.queue
            or any(r is not None for r in self.scheduler.active)
            or self._imports
        )

    # ---------------- handoff (prefill role) ----------------

    def _on_handoff(self, payload: PrefillHandoff) -> None:
        """Scheduler hook: stamp the payload's link-ready time (the prefill
        was charged already) and record the transit as the request's
        ``handoff`` span; the decode side resumes exactly at ``ready``."""
        t0 = self.spans.now()
        ready = self.clock + payload.n_tokens * self.cost.handoff_s_per_token
        self.outbox.append((ready, payload))
        self.spans.mark(
            payload.rid, "handoff", t0, ready, tokens=payload.n_tokens,
            kv_bytes=payload.kv_bytes,
        )
        self.spans.event("handoff", payload.rid, t0)
        self.spans.forget(payload.rid)

    # ---------------- the engine round ----------------

    def _try_imports(self) -> None:
        while self._imports:
            ready_at, rid = self._imports[0]
            if ready_at > self.clock:
                if not (
                    self.scheduler.queue
                    or any(r is not None for r in self.scheduler.active)
                ):
                    self.clock = ready_at  # nothing else to run: wait for it
                else:
                    break
            payload = self._import_payloads[rid]
            if not self.scheduler.import_prefilled(payload, ready_at=ready_at):
                break  # no lane / budget yet; decode below frees one
            self._imports.pop(0)
            del self._import_payloads[rid]
            self._import_tokens -= payload.total_tokens

    def step_round(self) -> None:
        """One scheduler round on the virtual clock. The scheduler's charge
        hook advances the clock as each step runs, so the only cost added
        here is the round's host overhead, and the milestone events and
        spans already carry exact mid-round stamps."""
        self._try_imports()
        self.scheduler.round()
        self._vclock.advance(self.cost.round_overhead_s)
        new_events = self.spans.drain_events()
        self._note_events(new_events)
        self.events.extend(new_events)
        # the scheduler's round record, stamped with the post-round clock
        # and this round's milestone events
        for rec in self._pending_records:
            rec["engine"] = self.engine_id
            rec["role"] = self.role
            rec["clock_s"] = round(self.clock, 9)
            rec["events"] = list(new_events)
            self.tracker.log_metrics(rec, step=rec["round"])
        self._pending_records.clear()
        self.spans.flush()

    def _note_events(self, events) -> None:
        """Fold milestone events into the per-request marks and, at
        completion, feed the streaming SLO monitor."""
        for kind, rid, t in events:
            marks = self._marks.setdefault(rid, {})
            if kind == "handoff":
                # it finishes elsewhere; the decode engine observes it
                self._marks.pop(rid, None)
                continue
            marks[kind] = t
            if kind != "done":
                continue
            req = self.scheduler.requests.get(rid)
            n = len(req.output) if req is not None else 0
            first = marks.get("first", t)
            sub = marks.get("submit", math.nan)
            adm = marks.get("admit", math.nan)
            self.slo_monitor.observe(
                t=t,
                ttft=first - sub,
                ttft_admit=first - adm,
                tpot=(t - first) / (n - 1) if n > 1 else 0.0,
                queue_wait=adm - sub,
            )
            self._marks.pop(rid, None)

    # ---------------- drain ----------------

    def drain(self):
        """Stop intake and hand queued (and mid-chunked-prefill) requests
        back to the router."""
        self.drained = True
        moved = self.scheduler.drain()
        for req in moved:
            self._marks.pop(req.rid, None)
        return moved

    def undrain(self) -> None:
        """Reopen intake after a drain (an engine cycles out and back in
        without being rebuilt)."""
        self.drained = False

    def summary(self) -> dict:
        s = self.scheduler.stats
        return {
            "engine": self.engine_id,
            "role": self.role,
            "clock_s": round(self.clock, 6),
            "completed": s.completed,
            "handoffs": s.handoffs,
            "prefill_steps": s.prefill_steps,
            "prefill_tokens": s.prefill_tokens,
            "prefix_hits": s.prefix_hits,
            "prefix_hit_tokens": s.prefix_hit_tokens,
            "prefix_hit_rate": round(s.prefix_hit_rate, 4),
            "shared_blocks_peak": s.shared_blocks_peak,
            "cached_blocks": self.scheduler.pool.cached_blocks,
            "decode_steps": s.decode_steps,
            "generated_tokens": s.generated_tokens,
            "expert_tokens": s.expert_tokens,
            "accepted_tokens": s.accepted_tokens,
            "draft_tokens": s.draft_tokens,
            "verify_steps": s.verify_steps,
            "accepted_per_step": round(s.accepted_per_step, 4),
            "pool_utilization": round(s.steady_state_utilization, 4),
            "spans": self.spans.n_spans,
            "slo": self.slo_monitor.summary(now=self.clock),
            "mem": self.mem_monitor.summary(now=self.clock),
            "fragmentation": self.scheduler.pool.fragmentation_report(),
        }
