"""Continuous-batching request scheduler over a shared KV pool.

Port of ``repro.runtime.scheduler`` for the dense, MoE and hybrid families.
Request lifecycle: QUEUED -> PREFILL -> DECODE -> DONE. Admission is token-budget
bound (committed prompt+generation tokens across in-flight requests never
exceed ``token_budget``) and pool-bound (the ``KVPool`` must hold the
request's full block commitment). A prompt within ``prefill_chunk``
prefills in one bucketed step; a longer one streams through
``prefill_chunk``-sized rounds. Decode lanes run the pool-indexed paged
step, each lane at its own depth.

``decode_per_round`` (R_F) is how many decode steps run per admission
round; the default is ``ceil(required_rf(slots))``, the paper's Eq. 2
with H_B = slots co-resident requests over a dual-port memory.

``residency`` (a ``runtime.residency`` plan) runs decode through the
budgeted step: the plan's streamed layers (MoE: experts) run their FFN
through ``stream_matmul``, the rest the resident path; prefill stays
resident.

MoE: every step's (L, E) routed-token tally is folded into a cumulative
tally (``_note_expert_counts``; padded prompt rows and idle decode lanes
route and count, as in the reference), from which each round record
derives the expert-load gauges.

Hybrid (Zamba2): the pool pages only the shared attention block's K/V
rows; each decode lane also holds a fixed-size SSM state (``_lane_state``,
leaves (L, slots, ...) on the pool's device: the f32 SSD state and the
conv buffers), which the decode step advances in place. Hybrid prompts
never pad (the SSD state integrates every position): a prompt within
``prefill_chunk`` prefills unpadded in one step at its own length, and a
longer one streams through the suffix step, each chunk resuming from the
state the last one left (``_chunk_lane``), so chunked prefill gives the
single-shot tokens. The prefix cache stores an **anchor** beside the
blocks: a host copy of the lane's state (``_lane_snapshot``, 72 MB a lane
at zamba2-2.7b) at the committed prompt's end and at the conversation's
end; a hybrid lookup matches anchors only, and a hit resumes the suffix
from the anchor's copy.

``prefix_cache`` (a ``runtime.prefix_cache.PrefixCache`` over this pool)
makes a new request adopt its longest cached prefix's blocks and prefill
only the unmatched suffix, through the chunk step from the matched
position on, whatever the prompt's length. A prompt is committed to the
cache at its first token, and again with its generated tokens at
completion, so a follow-up turn adopts the whole transcript.

Compiled steps, the counterpart of the reference's jitted ones: on a CUDA
pool every step runs as a captured CUDA graph
(``runtime.steps.CapturedStep``), captured at its first use. They belong
to this scheduler, since a graph binds the addresses of its parameters and
pool: one decode graph (its slots, ``S_max`` and residency plan are fixed
here), one chunk graph for every chunk (``start`` and the last index are
device inputs: ``flash_fwd`` reads its ``q_offset`` from the card), and
one whole-prompt prefill graph per bucket (a multiple of
``block_tokens`` up to ``prefill_chunk``, as the reference compiles one
program per bucket shape), all in one memory pool. ``compiled=False`` runs
every step eagerly on the card; the CPU has no graphs, so a CPU pool runs
eagerly and ``compiled=True`` on it raises. For hybrid, what recurs is
captured: the decode step (every lane's SSM state a static buffer,
advanced in place) and the full-width suffix chunk (``prefill_chunk``
tokens; the carried lane state is copied into the graph's static lane
buffer before a replay and out after it). Unpadded whole prompts and
shorter chunk tails run eagerly: their lengths vary, and the reference
traces one program per length.

``speculative`` (a ``runtime.speculative.Speculator``) replaces each
decode step with a speculate-and-verify cycle: the drafter proposes a
chain per decode lane and one batched verify step scores them all
(``_spec_step``). On a CUDA pool the verify step is one graph per chain
length seen (tokens, write rows, starts and the row table are its device
inputs), and a model drafter's decode and prompt prefill steps are graphs
in the same memory pool.

Observability, as in the reference: ``tracker`` gets one record a round
(``runtime.tracker``), ``spans`` a ``SpanRecorder`` (``runtime.spans``),
``ledger`` a ``MemLedger`` attached to the pool (``runtime.memledger``)
and ``mem_monitor`` a ``MemPressureMonitor`` fed once a round.

The fleet's hooks (``runtime.cluster``), as in the reference: ``handoff``
makes a prefill-role scheduler export each prefilled request as a
``PrefillHandoff`` (its K/V rows copied on the card in block order, its
first token, and for a hybrid a device copy of its lane state) instead of
decoding it, and ``import_prefilled`` adopts one on a decode-role
scheduler, writing the pool, the lane and the step buffers in place, so a
decode graph already captured stays valid. ``drain`` gives queued and
mid-chunk requests back to a router. ``charge(op, tokens=, steps=)`` is
called where each unit of work ends (a fleet engine advances its virtual
clock there, so spans, ledger and pressure monitor read that clock), and
``on_round`` takes the round record in place of the tracker.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core.gals import required_rf
from repro_torch.models.config import (
    POOL_FAMILIES,
    PREFIX_CACHE_FAMILIES,
    ModelConfig,
)
from repro_torch.models.lm import (
    LANE_KEYS,
    LMParams,
    SamplingParams,
    init_ssm_lane_state,
    sample_logits,
)
from repro_torch.runtime.tracker import DELTA_KEYS
from repro_torch.runtime.kv_pool import KVPool
from repro_torch.runtime.residency.plan import RuntimeResidencyPlan
from repro_torch.runtime.speculative import SPEC_FAMILIES, LaneDraft
from repro_torch.runtime.steps import (
    CapturedStep,
    make_budgeted_paged_serve_step,
    make_chunk_prefill_step,
    make_hybrid_suffix_prefill_step,
    make_paged_serve_step,
    make_pool_prefill_step,
    make_verify_step,
)

class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    HANDOFF = "handoff"  # prefilled here, decoded on another engine
    DONE = "done"


@dataclasses.dataclass
class PrefillHandoff:
    """A prefilled request leaving a prefill-role engine.

    ``k``/``v`` hold the request's K/V rows in block order, shaped (L,
    n_tokens, n_kv, hd), copies on the source pool's device
    (``KVPool.export_blocks``); ``block_ids`` records which blocks held
    them. A hybrid request also ships ``lane_state``, a device copy of its
    lane's SSM state at the prompt's end (leaves (L, 1, ...)), which the
    source lane does not alias.
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    first_token: int
    n_tokens: int
    block_ids: tuple[int, ...]
    block_tokens: int
    k: torch.Tensor
    v: torch.Tensor
    lane_state: dict[str, torch.Tensor] | None = None

    @property
    def kv_bytes(self) -> int:
        lane = (sum(t.nbytes for t in self.lane_state.values())
                if self.lane_state is not None else 0)
        return self.k.nbytes + self.v.nbytes + lane

    @property
    def total_tokens(self) -> int:
        return self.n_tokens + self.max_new_tokens


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    state: RequestState = RequestState.QUEUED
    output: list[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = 0.0

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_submit

    def _enter(self, state: RequestState) -> None:
        self.state = state


def _split(out: tuple, moe: bool) -> tuple[tuple, torch.Tensor | None]:
    """A pool step's outputs: its first three, and its (L, E) expert tally
    (the MoE family's fourth output) or None."""
    return out[:3], (out[3] if moe else None)


@dataclasses.dataclass
class SchedulerStats:
    completed: int = 0
    generated_tokens: int = 0
    prefill_steps: int = 0
    prefill_tokens: int = 0  # charged for the *unmatched* suffix only
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0  # prompt tokens served from cached blocks
    decode_steps: int = 0
    handoffs: int = 0  # prefilled requests exported to another engine
    expert_tokens: int = 0  # moe: routed (token, expert) slots, all layers
    # speculative decode: tokens emitted by verify steps (1..k each),
    # drafter proposals offered, and batched verify calls run
    accepted_tokens: int = 0
    draft_tokens: int = 0
    verify_steps: int = 0
    rounds: int = 0
    ttfts: list[float] = dataclasses.field(default_factory=list)
    util_samples: list[float] = dataclasses.field(default_factory=list)
    util_samples_any: list[float] = dataclasses.field(default_factory=list)
    shared_blocks_peak: int = 0
    decode_time: float = 0.0

    @property
    def mean_ttft(self) -> float:
        return sum(self.ttfts) / len(self.ttfts) if self.ttfts else 0.0

    @property
    def accepted_per_step(self) -> float:
        """Mean tokens emitted per verify step (1.0: no draft ever
        accepted); speculative decode's whole win is this number."""
        if not self.verify_steps:
            return 0.0
        return self.accepted_tokens / self.verify_steps

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of submitted prompt tokens served from the cache
        (hit tokens / (hit tokens + prefilled tokens))."""
        total = self.prefix_hit_tokens + self.prefill_tokens
        return self.prefix_hit_tokens / total if total else 0.0

    @property
    def steady_state_utilization(self) -> float:
        """Mean pool utilization over decode steps with all lanes busy
        (or, if the trace never fills every lane, with any lane busy)."""
        samples = self.util_samples or self.util_samples_any
        return sum(samples) / len(samples) if samples else 0.0


class Scheduler:
    """Drives requests through a fixed set of decode lanes over a KVPool.

    The steps run on the pool's device; logits come back to the host once
    per step, where sampling happens in numpy.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: LMParams,
        pool: KVPool,
        *,
        slots: int,
        max_len: int,
        token_budget: int | None = None,
        decode_per_round: int | None = None,
        sampling: SamplingParams | None = None,
        prefill_chunk: int | None = None,
        residency: RuntimeResidencyPlan | None = None,
        compiled: bool | None = None,
        handoff: Callable[[PrefillHandoff], None] | None = None,
        prefix_cache=None,
        speculative=None,
        tracker=None,
        spans=None,
        ledger=None,
        mem_monitor=None,
    ):
        if cfg.family not in POOL_FAMILIES:
            raise ValueError(
                f"Scheduler: family {cfg.family!r} is not ported to the pool engine "
                f"(ported: {', '.join(POOL_FAMILIES)})"
            )
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.device = pool.device
        # compiled steps are CUDA graphs: on by default on a CUDA pool; the
        # CPU has none, and asking for them there is an error, not a fallback
        if compiled is None:
            compiled = self.device.type == "cuda"
        if compiled and self.device.type != "cuda":
            raise ValueError(
                f"compiled steps are CUDA graphs; the pool is on {self.device}, "
                "which has none (pass compiled=False or leave it None)"
            )
        self.compiled = compiled
        self._graph_pool = torch.cuda.graph_pool_handle() if compiled else None
        self._decode_graph: CapturedStep | None = None
        self._chunk_graph: CapturedStep | None = None
        self._prefill_graphs: dict[int, CapturedStep] = {}  # by bucket
        self._verify_graphs: dict[int, CapturedStep] = {}  # by chain length
        # a prefill-role engine exports each prefilled request through this
        # hook instead of decoding it (it never runs a decode step)
        self.handoff = handoff
        if prefix_cache is not None:
            if cfg.family not in PREFIX_CACHE_FAMILIES:
                raise ValueError(
                    f"prefix caching covers {PREFIX_CACHE_FAMILIES}; "
                    f"family {cfg.family!r} cannot prefill a bare suffix"
                )
            if prefix_cache.pool is not pool:
                raise ValueError("prefix cache must index this pool")
        self.prefix_cache = prefix_cache
        # speculative decode (runtime.speculative.Speculator): a drafter
        # proposes depth-k chains per decode lane; one batched verify step
        # scores them all and the longest sampled-equal prefix is accepted
        if speculative is not None and cfg.family not in SPEC_FAMILIES:
            raise ValueError(
                f"speculative decoding covers {SPEC_FAMILIES}; family "
                f"{cfg.family!r} has no draft-chain rollback path"
            )
        self.speculative = speculative
        self._verify = make_verify_step(cfg) if speculative is not None else None
        # host seconds of the verify steps, each from its inputs to its
        # logits on the host, and of the drafter's proposals; verify steps
        # by chain length (the batch's rows are slots x length)
        self.verify_s = 0.0
        self.propose_s = 0.0
        self.verify_lengths: dict[int, int] = {}
        if speculative is not None and compiled:
            speculative.use_graphs(self._graph_pool)
        self.slots = slots
        self.max_len = max_len
        self.s_max = pool.max_rows(max_len)
        usable_tokens = pool.usable_blocks * pool.block_tokens
        self.token_budget = min(token_budget or usable_tokens, usable_tokens)
        self.decode_per_round = decode_per_round or max(
            1, math.ceil(required_rf(slots))
        )
        self.sampling = sampling or SamplingParams()
        self.prefill_chunk = min(
            prefill_chunk or self.token_budget, self.token_budget
        )
        self._hybrid = cfg.family == "hybrid"
        self._prefill = make_pool_prefill_step(cfg)
        # hybrid chunks through the carried-state suffix step, not the
        # stateless attention chunk step
        self._chunk_prefill = (
            make_hybrid_suffix_prefill_step(cfg) if self._hybrid
            else make_chunk_prefill_step(cfg)
        )
        # a residency plan sends decode through the budgeted step: its
        # streamed layers run the FFN through stream_matmul
        self.residency = residency
        self._decode = (
            make_budgeted_paged_serve_step(
                cfg, residency.stream_mask(cfg), residency.stream_ahead
            )
            if residency is not None
            else make_paged_serve_step(cfg)
        )
        # moe expert-load observability: the cumulative (L, E) routed-token
        # tally of every step, and the plan's resident (L, E) set (every
        # expert without a plan); the round record's gauges read both
        self._moe = cfg.family == "moe"
        self._expert_counts = (
            np.zeros((cfg.n_layers, cfg.n_experts), np.float64) if self._moe else None
        )
        self._expert_resident = None
        if self._moe and residency is not None:
            self._expert_resident = ~np.asarray(residency.expert_stream_mask(cfg), bool)
        self._chunk_cursor: dict[int, int] = {}
        # hybrid: every lane's SSM decode state, resident next to the pool
        # (which pages only the shared attention blocks' K/V); a long
        # prompt's carried state between its chunks (leaves (L, 1, ...)),
        # keyed like the cursor and moved into the lane on the last chunk;
        # the chunk graph's static lane buffer; and the anchors' host copies:
        # their count, bytes and host seconds (device to host)
        self._lane_state = (
            init_ssm_lane_state(cfg, slots, device=self.device) if self._hybrid else None
        )
        self._chunk_lane: dict[int, dict[str, torch.Tensor]] = {}
        self._chunk_lane_buf: dict[str, torch.Tensor] | None = None
        self.snapshots = 0
        self.snapshot_bytes = 0
        self.snapshot_s = 0.0
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self.active: list[int | None] = [None] * slots
        self._token = np.zeros((slots, 1), np.int32)
        self._lengths = np.zeros((slots,), np.int32)
        # per-lane physical row tables, updated on admission / block growth
        # / completion; eager steps re-upload the device copy only when it
        # is dirty, compiled ones copy it into the graph's buffer every step
        self._row_table = np.tile(pool.scratch_rows(self.s_max), (slots, 1))
        self._row_table_dev = self._to_device(self._row_table)
        self._table_dirty = False
        self._next_rid = 0
        self.stats = SchedulerStats()
        # one record per round (runtime.tracker): counters as deltas
        # against ``_emit_base``, so replaying a stream gives the totals
        self.tracker = tracker
        # a fleet engine takes the round record here instead (to stamp its
        # virtual clock and identity on it before logging)
        self.on_round: Callable[[dict], None] | None = None
        self._emit_base: dict[str, int] = {}
        self._emit_ttft_base = 0
        # request-lifecycle spans (runtime.spans.SpanRecorder): queue /
        # prefill chunk / decode slice per request, tiled without gaps
        self.spans = spans
        # the virtual-time hook a fleet engine installs: charge(op,
        # tokens=, steps=) with op "prefill", "decode", "draft" or "verify",
        # called as each unit of work ends, before the span that ends there
        # reads the clock
        self.charge: Callable[..., None] | None = None
        # open decode slices: rid -> [t_slice_start, steps] for the
        # contiguous decode steps a lane ran this round (one span each)
        self._decode_open: dict[int, list] = {}
        # event-sourced memory ledger (runtime.memledger.MemLedger): every
        # pool mutation emits a kind="mem" delta record; the round emission
        # syncs + flushes it before the gauge record
        self.ledger = ledger
        if ledger is not None and ledger.pool is None:
            ledger.attach(pool)
        self.mem_monitor = mem_monitor
        if ledger is not None and residency is not None:
            # static owners: the plan's resident tiles and its stream ring
            # (plan arithmetic, as in the reference)
            ledger.reserve(
                "weight-resident",
                residency.resident_bytes,
                blocks=residency.resident_block_count,
            )
            ledger.reserve(
                "ring-slot", residency.ring_bytes, depth=residency.stream_ahead
            )
        if tracker is not None:
            hp = {
                "surface": "scheduler",
                "arch": cfg.name,
                "family": cfg.family,
                "slots": slots,
                "max_len": max_len,
                "token_budget": self.token_budget,
                "decode_per_round": self.decode_per_round,
                "prefill_chunk": self.prefill_chunk,
                "block_tokens": pool.block_tokens,
                "pool_blocks": pool.usable_blocks,
                "prefix_cache": prefix_cache is not None,
                "compiled": self.compiled,
            }
            if speculative is not None:
                hp["speculate"] = speculative.name
                hp["spec_depth"] = speculative.depth
            if residency is not None:
                hp["residency"] = residency.summary()
            tracker.log_hyperparameters(hp)

    def _mem_clock(self) -> float:
        """The pressure monitor's clock: the spans' when there are spans,
        else the host's monotonic clock (``mem_summary`` reads the same)."""
        return self.spans.now() if self.spans is not None else time.monotonic()

    def mem_summary(self) -> dict:
        """The pressure monitor's summary now, on the clock it was fed."""
        return self.mem_monitor.summary(now=self._mem_clock())

    @property
    def decode_graph(self) -> CapturedStep | None:
        """The captured decode step, once the first compiled step ran."""
        return self._decode_graph

    @property
    def graphs(self) -> list[CapturedStep]:
        """The captured steps so far: the decode step's, the chunk's, each
        prefill bucket's, each chain length's verify step, then the model
        drafter's."""
        one = [g for g in (self._decode_graph, self._chunk_graph) if g is not None]
        spec = self.speculative.graphs if self.speculative is not None else []
        return (one + list(self._prefill_graphs.values())
                + list(self._verify_graphs.values()) + spec)

    @property
    def verify_graphs(self) -> dict[int, CapturedStep]:
        """The captured verify steps, by chain length."""
        return dict(self._verify_graphs)

    @property
    def prefill_buckets(self) -> list[int]:
        """The buckets whose whole-prompt prefill has a captured graph."""
        return sorted(self._prefill_graphs)

    @staticmethod
    def _host_tensor(a) -> torch.Tensor:
        """An int64 host tensor of ``a``, for a captured step's buffers."""
        return torch.from_numpy(np.asarray(a, np.int64))

    def _to_device(self, a) -> torch.Tensor:
        return self._host_tensor(a).to(self.device)

    # ---------------- submission ----------------

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        *,
        rid: int | None = None,
        t_submit: float | None = None,
    ) -> int:
        """Queue a request. The sampler is keyed on (seed, rid, position),
        so a request's token stream does not depend on its lane or engine
        (a fleet router passes fleet-wide ids). ``t_submit`` starts the
        queue span on the spans' clock (a router passes the client's
        arrival; default: now)."""
        total = len(prompt) + max_new_tokens
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        if total > self.max_len:
            raise ValueError(
                f"request needs {total} tokens > max_len {self.max_len}"
            )
        usable = self.pool.usable_blocks * self.pool.block_tokens
        if total > usable:
            raise ValueError(
                f"request needs {total} tokens > pool capacity {usable}"
            )
        if rid is None:
            rid = self._next_rid
        elif rid in self.requests:
            raise ValueError(f"request id {rid} already known")
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid, np.asarray(prompt, np.int32), max_new_tokens)
        req.t_submit = time.monotonic()
        req._enter(RequestState.QUEUED)
        self.queue.append(req)
        self.requests[rid] = req
        if self.spans is not None:
            self.spans.open(rid, "queue", t0=t_submit)
        return rid

    def drain(self) -> list[Request]:
        """Stop intake: pop and return every request this engine can still
        give up, for a router to requeue elsewhere (sampling is rid-keyed,
        so the stream survives the move): the queue, and any request mid
        chunked prefill, whose blocks, cursor, carried hybrid state and
        lane are released here (it has sampled no token yet), so it
        restarts cold with nothing leaked. Decoding requests finish here."""
        out: list[Request] = []
        # aborted chunked prefills first: older than anything still queued
        for slot, rid in enumerate(self.active):
            if rid is None or rid not in self._chunk_cursor:
                continue
            req = self.requests.pop(rid)
            del self._chunk_cursor[rid]
            self._chunk_lane.pop(rid, None)
            self.pool.release(rid)
            self.active[slot] = None
            self._token[slot, 0] = 0
            self._lengths[slot] = 0
            self._row_table[slot] = self.pool.scratch_rows(self.s_max)
            self._table_dirty = True
            req.output.clear()
            req._enter(RequestState.QUEUED)
            if self.spans is not None:
                self.spans.abort(rid, reason="drain")
            out.append(req)
        while self.queue:
            req = self.queue.popleft()
            del self.requests[req.rid]
            if self.spans is not None:
                self.spans.abort(req.rid, reason="drain")
            out.append(req)
        return out

    # ---------------- internals ----------------

    @property
    def committed_tokens(self) -> int:
        return sum(
            self.requests[r].total_tokens for r in self.active if r is not None
        )

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _sample_one(self, req: Request, row: np.ndarray) -> int:
        """Next token for one request from its (V,) logits row, from an rng
        keyed on (seed, rid, position)."""
        sp = self.sampling
        rng = np.random.default_rng(
            np.random.SeedSequence([sp.seed, req.rid, len(req.output)])
        )
        return sample_logits(row, sp, rng)

    @staticmethod
    def _host(logits: torch.Tensor) -> np.ndarray:
        return logits.to(torch.float32).cpu().numpy()

    def _note_expert_counts(self, counts: torch.Tensor | None) -> None:
        """Fold one step's (L, E) routed-token tally into the run's totals
        (nothing for the dense family, whose steps return none). Padded
        prompt rows and idle decode lanes route too: the gauges are a load
        signal, not an exact busy-token count."""
        if counts is None:
            return
        c = counts.to(torch.float64).cpu().numpy()
        self._expert_counts += c
        self.stats.expert_tokens += int(c.sum())

    # ---------------- admission / prefill ----------------

    def _lane_snapshot(self, slot: int) -> dict[str, torch.Tensor]:
        """A host copy of one lane's SSM state (leaves (L, 1, ...)), the
        reference's ``np.asarray`` of it: an anchor must not follow the
        lane, which later steps advance in place."""
        t0 = time.perf_counter()
        snap = {k: v[:, slot:slot + 1].to("cpu", copy=True) for k, v in self._lane_state.items()}
        self.snapshot_s += time.perf_counter() - t0
        self.snapshots += 1
        self.snapshot_bytes += sum(v.nbytes for v in snap.values())
        return snap

    def _restore_lane(self, slot: int, lane: dict[str, torch.Tensor]) -> None:
        """Copy a lane state (leaves (L, 1, ...), on any device) into lane
        ``slot``, in place: the decode graph keeps its buffers."""
        for key in LANE_KEYS:
            self._lane_state[key][:, slot].copy_(lane[key][:, 0])

    def _commit_prefix(self, slot: int, req: Request) -> None:
        """Index the freshly prefilled prompt in the radix cache: its full
        blocks become shared nodes; a hybrid also anchors its lane's SSM
        state at the prompt's end (taken before decode advances it)."""
        if self.prefix_cache is not None:
            lane = self._lane_snapshot(slot) if self._hybrid else None
            self.prefix_cache.commit(req.prompt, self.pool.blocks_of(req.rid), lane_state=lane)

    def _commit_generated(self, slot: int, req: Request) -> None:
        """Re-index the finished conversation, prompt plus generated
        tokens, so a follow-up turn adopts the whole transcript's blocks.
        The last sampled token never went through the model and has no KV
        row, so the committed sequence stops one short of the output. Runs
        before ``pool.release``: the cache pins blocks of a live request."""
        if self.prefix_cache is None:
            return
        seq = np.concatenate([req.prompt, np.asarray(req.output[:-1], np.int32)])
        if len(seq) == len(req.prompt):
            return  # a 1-token request: the prompt's commit covers it
        lane = self._lane_snapshot(slot) if self._hybrid else None
        self.prefix_cache.commit(seq, self.pool.blocks_of(req.rid), lane_state=lane)

    def _start_decode(self, slot: int, req: Request, first: int, t_first: float) -> None:
        """Move a fully-prefilled request onto its decode lane, or, on a
        prefill-role engine, export it through the handoff hook. ``t_first``
        is the span clock's end of the prefill step that made ``first``."""
        req.t_first_token = time.monotonic()
        self.stats.ttfts.append(req.ttft)
        req.output.append(first)
        self._commit_prefix(slot, req)
        if self.handoff is not None:
            self._export_handoff(slot, req)
            return
        if self.spans is not None:
            # the first token exists the instant its prefill step ends: the
            # stamp is that span's end, a boundary on any clock
            self.spans.event("first", req.rid, t_first)
        req._enter(RequestState.DECODE)
        self._token[slot, 0] = first
        self._lengths[slot] = len(req.prompt)
        self._row_table[slot] = self.pool.rows_of(req.rid, pad_to=self.s_max)
        self._table_dirty = True
        t_done = t_first
        if self.speculative is not None:
            t_done = self._start_drafter(slot, req, t_first)
        if len(req.output) >= req.max_new_tokens:
            self._complete(slot, t_done)

    def _start_drafter(self, slot: int, req: Request, t_first: float) -> float:
        """Warm the drafter's lane for a request entering decode. A model
        drafter prefills the prompt through its own weights (the target's
        prefix-cache hits do not transfer), attributed to a ``draft`` span.
        Returns the end of the request's last span: the draft span's, else
        ``t_first``."""
        t0 = self.spans.now() if self.spans is not None else 0.0
        tokens, steps = self.speculative.start_lane(slot, req.prompt)
        if tokens or steps:
            if self.charge is not None:
                self.charge("draft", tokens=tokens, steps=steps)
            if self.spans is not None:
                t1 = self.spans.now()
                self.spans.mark(req.rid, "draft", t0, t1, tokens=tokens)
                return t1
        return t_first

    def _export_handoff(self, slot: int, req: Request) -> None:
        """Ship a prefilled request's K/V (in block order) and, for a
        hybrid, a device copy of its lane state off this engine, and take
        its lane and blocks back at once."""
        rid = req.rid
        p = len(req.prompt)
        block_ids, ks, vs = self.pool.export_blocks(rid, n_tokens=p)
        lane = ({k: v[:, slot:slot + 1].clone() for k, v in self._lane_state.items()}
                if self._hybrid else None)
        payload = PrefillHandoff(
            rid=rid, prompt=req.prompt, max_new_tokens=req.max_new_tokens,
            first_token=req.output[0], n_tokens=p, block_ids=block_ids,
            block_tokens=self.pool.block_tokens, k=ks, v=vs, lane_state=lane,
        )
        req._enter(RequestState.HANDOFF)
        self.pool.release(rid)
        self.active[slot] = None
        self.stats.handoffs += 1
        self.handoff(payload)

    def import_prefilled(
        self, payload: PrefillHandoff, *, ready_at: float | None = None
    ) -> bool:
        """Adopt a request prefilled on another engine: admit its whole
        token commitment, write the handed-off K/V rows into the pool, and
        start its decode lane at the next position. Every write is in
        place (the pool through ``write_prefill``, the lane through
        ``_restore_lane``, the token, length and row-table buffers as
        ``_start_decode`` writes them), so a captured decode graph stays
        valid. Returns False, with no side effect, when no lane, budget or
        pool room is free. ``ready_at`` is when the payload arrived on the
        spans' clock: the request's timeline resumes there, and any wait
        for a lane shows as a ``wait`` span."""
        if payload.rid in self.requests:
            raise ValueError(f"request {payload.rid} already on this engine")
        slot = self._free_slot()
        if slot is None:
            return False
        total = payload.total_tokens
        if self.committed_tokens + total > self.token_budget:
            return False
        if not self.pool.can_admit(total):
            return False
        if self._hybrid and payload.lane_state is None:
            raise ValueError(
                f"hybrid handoff of request {payload.rid} lacks the SSM "
                "lane state; decode cannot resume from KV rows alone"
            )
        rid = payload.rid
        req = Request(rid, np.asarray(payload.prompt, np.int32), payload.max_new_tokens)
        req.t_submit = time.monotonic()
        req.t_first_token = req.t_submit  # the first token came with the K/V
        req.output.append(payload.first_token)
        req._enter(RequestState.DECODE)
        self.requests[rid] = req
        self.pool.admit(rid, total)
        self.pool.write_prefill(rid, payload.k, payload.v, n_tokens=payload.n_tokens)
        if self._hybrid:
            self._restore_lane(slot, payload.lane_state)
        if self.prefix_cache is not None:
            # the imported K/V warms this engine's cache too (a hybrid's
            # anchor is a host copy, as every anchor is)
            lane = self._lane_snapshot(slot) if self._hybrid else None
            self.prefix_cache.commit(req.prompt, self.pool.blocks_of(rid), lane_state=lane)
        self._next_rid = max(self._next_rid, rid + 1)
        self.active[slot] = rid
        self._token[slot, 0] = payload.first_token
        self._lengths[slot] = payload.n_tokens
        self._row_table[slot] = self.pool.rows_of(rid, pad_to=self.s_max)
        self._table_dirty = True
        now = 0.0
        if self.spans is not None:
            now = self.spans.now()
            t_ready = now if ready_at is None else min(ready_at, now)
            self.spans.seed(rid, t_ready)
            if now > t_ready:
                self.spans.mark(rid, "wait", t_ready, now, reason="import")
            # the first token came with the payload: the client sees it the
            # instant this engine adopts it
            self.spans.event("first", rid, now)
        t_done = now
        if self.speculative is not None:
            t_done = self._start_drafter(slot, req, now)
        if len(req.output) >= req.max_new_tokens:
            self._complete(slot, t_done if self.spans is not None else None)
        return True

    def _admit_one(self) -> bool:
        """Admit the head-of-queue request if resources allow.

        Prompts within ``prefill_chunk`` prefill in one bucketed step
        (hybrid: unpadded); longer prompts are admitted only when no other
        request holds budget, then stream through ``prefill_chunk``-sized
        rounds. A prefix-cache hit adopts the matched blocks and prefills
        the rest through chunks from the matched position, whatever the
        length; a hybrid looks up anchors only and resumes from the
        anchor's copy of the SSM state (the zero state on a miss).
        """
        if not self.queue:
            return False
        slot = self._free_slot()
        if slot is None:
            return False
        req = self.queue[0]
        over_budget = self.committed_tokens + req.total_tokens > self.token_budget
        if over_budget and self.committed_tokens > 0:
            return False
        if not self.pool.can_admit(req.total_tokens):
            return False
        self.queue.popleft()
        req._enter(RequestState.PREFILL)
        t_admit = 0.0
        if self.spans is not None:
            t_admit = self.spans.close(req.rid)  # ends the queue span
            self.spans.event("admit", req.rid, t_admit)
        self.pool.admit(req.rid, req.total_tokens)
        p = len(req.prompt)

        # radix-cache lookup: adopt the longest cached prefix's blocks
        # (refcount bump; copy-on-write for a partially matched block)
        match = None
        if self.prefix_cache is not None:
            match = self.prefix_cache.lookup(req.prompt, anchor=self._hybrid)
        if match is not None:
            self.pool.adopt_prefix(req.rid, match.shared, match.tail_block, match.matched)
            self.stats.prefix_hits += 1
            self.stats.prefix_hit_tokens += match.matched
        if self.spans is not None and self.prefix_cache is not None:
            # zero-width: the lookup is bookkeeping, its matched length the signal
            self.spans.mark(
                req.rid, "prefix_lookup", t_admit, t_admit,
                matched=match.matched if match is not None else 0,
                hit=match is not None,
            )

        if match is not None or p > self.prefill_chunk:
            # chunked prefill from the matched position (0 on a miss)
            self.active[slot] = req.rid
            self._chunk_cursor[req.rid] = match.matched if match is not None else 0
            if self._hybrid:
                # a copy: the chunks advance it in place, the anchor stays
                self._chunk_lane[req.rid] = (
                    {k: v.to(self.device, copy=True) for k, v in match.lane_state.items()}
                    if match is not None else init_ssm_lane_state(self.cfg, 1, self.device)
                )
            self._prefill_one_chunk(slot)
            return True

        t = self.pool.block_tokens
        # hybrid prompts never pad: a padded tail would enter the SSD state
        bucket = p if self._hybrid else max(t, -(-p // t) * t)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :p] = req.prompt
        t0 = self.spans.now() if self.spans is not None else 0.0
        logits, ks, vs, extra = self._run_prefill(padded, p - 1)
        if self._hybrid:
            self._restore_lane(slot, extra)  # the post-prompt state moves into the lane
        else:
            self._note_expert_counts(extra)
        self.pool.write_prefill(req.rid, ks[:, 0], vs[:, 0], n_tokens=p)
        self.stats.prefill_steps += 1
        self.stats.prefill_tokens += p
        if self.charge is not None:
            self.charge("prefill", tokens=p, steps=1)
        t1 = 0.0
        if self.spans is not None:
            t1 = self.spans.now()
            self.spans.mark(req.rid, "prefill", t0, t1, tokens=p)
        first = self._sample_one(req, self._host(logits[0, 0]))
        self.active[slot] = req.rid
        self._start_decode(slot, req, first, t1)
        return True

    def _run_prefill(self, tokens: np.ndarray, last: int):
        """The whole-prompt prefill of one bucket (``tokens`` (1, bucket)):
        the bucket's captured graph (captured on first use), or the eager
        step. Returns (logits, ks, vs, the MoE tally or None; hybrid: the
        prompt's lane state); a graph's are its static outputs, which its
        next replay overwrites. A hybrid prompt (unpadded, any length)
        always runs eagerly."""
        if self._hybrid:
            return self._prefill(self.params, self._to_device(tokens), self._to_device([last]))
        if not self.compiled:
            out, tally = _split(self._prefill(
                self.params, self._to_device(tokens), self._to_device([last])
            ), self._moe)
            return out + (tally,)
        step = self._prefill_graphs.get(tokens.shape[1])
        if step is None:
            # the closure holds what the graph binds, not the scheduler: a
            # scheduler and its graphs are freed when the last reference goes
            prefill, params, moe = self._prefill, self.params, self._moe

            def whole(tok, last_idx):
                out, tally = _split(prefill(params, tok, last_idx), moe)
                return out + (tally,)

            step = CapturedStep(whole, device=self.device, mempool=self._graph_pool)
            self._prefill_graphs[tokens.shape[1]] = step
        return step(self._host_tensor(tokens), self._host_tensor([last]))

    def _run_chunk(self, tokens, row_table, write_rows, start: int, last: int):
        """One prefill chunk: the captured chunk graph (captured on first
        use; ``start`` and ``last`` are its device inputs, so it serves
        every chunk), or the eager step, given the same device tensors.
        Returns (logits, the MoE tally or None)."""
        if not self.compiled:
            out, tally = _split(self._chunk_prefill(
                self.params, self._to_device(tokens), self.pool.k, self.pool.v,
                self._to_device(row_table), self._to_device(write_rows),
                self._to_device([start]), self._to_device([last]),
            ), self._moe)
            return out[0], tally
        if self._chunk_graph is None:
            prefill, params, pk, pv, moe = (
                self._chunk_prefill, self.params, self.pool.k, self.pool.v, self._moe
            )

            def chunk(tok, table, rows, start_idx, last_idx):
                out, tally = _split(
                    prefill(params, tok, pk, pv, table, rows, start_idx, last_idx), moe
                )
                return out[0], tally

            self._chunk_graph = CapturedStep(
                chunk, device=self.device, mempool=self._graph_pool
            )
        return self._chunk_graph(
            self._host_tensor(tokens), self._host_tensor(row_table),
            self._host_tensor(write_rows), self._host_tensor([start]),
            self._host_tensor([last]),
        )

    def _run_hybrid_chunk(self, rid: int, tokens, row_table, write_rows, start: int,
                          last: int) -> torch.Tensor:
        """One hybrid chunk (``tokens`` (1, n), unpadded), resumed from and
        advancing ``_chunk_lane[rid]``: a full-width chunk through the
        captured suffix graph (captured on first use; the carried state is
        copied into its static lane buffer before the replay and out after
        it), a shorter one eagerly. Returns the logits."""
        lane = self._chunk_lane[rid]
        if not self.compiled or tokens.shape[1] != self.prefill_chunk:
            out = self._chunk_prefill(
                self.params, self._to_device(tokens), self.pool.k, self.pool.v,
                self._to_device(row_table), self._to_device(write_rows),
                self._to_device([start]), self._to_device([last]), lane,
            )
            return out[0]
        if self._chunk_graph is None:
            self._chunk_lane_buf = init_ssm_lane_state(self.cfg, 1, self.device)
            suffix, params, pk, pv, buf = (
                self._chunk_prefill, self.params, self.pool.k, self.pool.v,
                self._chunk_lane_buf,
            )

            def chunk(tok, table, rows, start_idx, last_idx):
                return suffix(params, tok, pk, pv, table, rows, start_idx, last_idx, buf)[0]

            self._chunk_graph = CapturedStep(chunk, device=self.device, mempool=self._graph_pool)
        for key in LANE_KEYS:
            self._chunk_lane_buf[key].copy_(lane[key])
        logits = self._chunk_graph(
            self._host_tensor(tokens), self._host_tensor(row_table),
            self._host_tensor(write_rows), self._host_tensor([start]),
            self._host_tensor([last]),
        )
        for key in LANE_KEYS:
            lane[key].copy_(self._chunk_lane_buf[key])
        return logits

    def _prefill_one_chunk(self, slot: int) -> None:
        """Run one ``prefill_chunk``-sized piece of a long prompt, padded
        to the fixed chunk width with scratch rows; a hybrid chunk runs
        unpadded (a padded tail would enter the carried SSD state) and
        resumes from ``_chunk_lane``, so chunked hybrid prefill gives the
        single-shot tokens."""
        rid = self.active[slot]
        req = self.requests[rid]
        c0 = self._chunk_cursor[rid]
        p = len(req.prompt)
        c = self.prefill_chunk
        n = min(c, p - c0)
        t0 = self.spans.now() if self.spans is not None else 0.0
        self.pool.note_tokens(rid, c0 + n)
        rows = self.pool.rows_of(rid)[c0 : c0 + n]
        row_table = self.pool.rows_of(rid, pad_to=self.s_max)[None]
        if self._hybrid:
            logits = self._run_hybrid_chunk(
                rid, req.prompt[None, c0 : c0 + n], row_table, rows[None], c0, n - 1
            )
        else:
            scratch = int(self.pool.scratch_rows(1)[0])
            write_rows = np.full((1, c), scratch, np.int32)
            write_rows[0, :n] = rows
            tokens = np.zeros((1, c), np.int32)
            tokens[0, :n] = req.prompt[c0 : c0 + n]
            logits, counts = self._run_chunk(tokens, row_table, write_rows, c0, n - 1)
            self._note_expert_counts(counts)
        self.stats.prefill_steps += 1
        self.stats.prefill_tokens += n
        if self.charge is not None:
            self.charge("prefill", tokens=n, steps=1)
        t1 = 0.0
        if self.spans is not None:
            t1 = self.spans.now()
            self.spans.mark(rid, "prefill", t0, t1, tokens=n, chunk_start=c0)
        self._chunk_cursor[rid] = c0 + n
        if c0 + n >= p:
            del self._chunk_cursor[rid]
            if self._hybrid:
                # the post-prompt state moves into the decode lane
                self._restore_lane(slot, self._chunk_lane.pop(rid))
            first = self._sample_one(req, self._host(logits[0, 0]))
            self._start_decode(slot, req, first, t1)

    def _complete(self, slot: int, t_done: float | None = None) -> None:
        rid = self.active[slot]
        req = self.requests[rid]
        req._enter(RequestState.DONE)
        self._commit_generated(slot, req)
        if self.speculative is not None:
            self.speculative.release_lane(slot)
        self.pool.release(rid)
        self.active[slot] = None
        self._token[slot, 0] = 0
        self._lengths[slot] = 0
        self._row_table[slot] = self.pool.scratch_rows(self.s_max)
        self._table_dirty = True
        self.stats.completed += 1
        self.stats.generated_tokens += len(req.output)
        if self.spans is not None:
            t = self.spans.now() if t_done is None else t_done
            sl = self._decode_open.pop(rid, None)
            if sl is not None:
                # completion lands exactly on this decode slice's end
                self.spans.mark(rid, "decode", sl[0], t, steps=sl[1])
            self.spans.event("done", rid, t)
            self.spans.forget(rid)

    def _decoding(self, rid: int | None) -> bool:
        return rid is not None and self.requests[rid].state is RequestState.DECODE

    def _run_decode(self):
        """One decode step over every lane: the captured graph (captured
        on first use), or the eager step. Returns (logits, the MoE tally or
        None). A hybrid step also advances every lane's SSM state in
        place (the graph binds ``_lane_state``)."""
        lane = (self._lane_state,) if self._hybrid else ()
        if not self.compiled:
            if self._table_dirty:
                self._row_table_dev = self._to_device(self._row_table)
                self._table_dirty = False
            out, tally = _split(self._decode(
                self.params,
                self._to_device(self._token),
                self.pool.k,
                self.pool.v,
                self._row_table_dev,
                self._to_device(self._lengths),
                *lane,
            ), self._moe)
            return out[0], tally
        if self._decode_graph is None:
            step, params, pk, pv, moe = (
                self._decode, self.params, self.pool.k, self.pool.v, self._moe
            )

            def decode(token, table, lengths):
                out, tally = _split(step(params, token, pk, pv, table, lengths, *lane), moe)
                return out[0], tally

            self._decode_graph = CapturedStep(
                decode, device=self.device, mempool=self._graph_pool
            )
        return self._decode_graph(
            self._host_tensor(self._token),
            self._host_tensor(self._row_table),
            self._host_tensor(self._lengths),
        )

    def _decode_step(self) -> None:
        t0_step = self.spans.now() if self.spans is not None else 0.0
        for i, rid in enumerate(self.active):
            if not self._decoding(rid):
                continue  # empty lane, or a mid-chunked-prefill reservation
            before = self.pool.blocks_held(rid)
            self.pool.note_tokens(rid, int(self._lengths[i]) + 1)
            if self.pool.blocks_held(rid) != before:
                self._row_table[i] = self.pool.rows_of(rid, pad_to=self.s_max)
                self._table_dirty = True
        logits, counts = self._run_decode()
        self._note_expert_counts(counts)
        self.stats.decode_steps += 1
        if self.charge is not None:
            self.charge("decode", steps=1)
        if self.spans is not None:
            # extend (or open) each participating lane's decode slice; a
            # lane's contiguous steps this round become one span
            for rid in self.active:
                if self._decoding(rid):
                    sl = self._decode_open.get(rid)
                    if sl is None:
                        self._decode_open[rid] = [t0_step, 1]
                    else:
                        sl[1] += 1
        rows = self._host(logits[:, 0, :])
        pool_st = self.pool.stats()
        util = pool_st.utilization
        self.stats.shared_blocks_peak = max(
            self.stats.shared_blocks_peak, pool_st.shared_blocks
        )
        self.stats.util_samples_any.append(util)
        if all(r is not None for r in self.active):
            self.stats.util_samples.append(util)
        for i, rid in enumerate(self.active):
            if not self._decoding(rid):
                continue
            req = self.requests[rid]
            nxt = self._sample_one(req, rows[i])
            req.output.append(nxt)
            self._token[i, 0] = nxt
            self._lengths[i] += 1
            if len(req.output) >= req.max_new_tokens:
                self._complete(i)

    def _run_verify(self, tokens, write_rows, starts) -> torch.Tensor:
        """One verify step over every lane (``tokens`` (slots, kmax)): the
        captured graph of this chain length (captured on first use; the
        tokens, write rows, starts and row table are its device inputs),
        or the eager step. Returns (logits, the MoE tally or None)."""
        if not self.compiled:
            if self._table_dirty:
                self._row_table_dev = self._to_device(self._row_table)
                self._table_dirty = False
            out, tally = _split(self._verify(
                self.params, self._to_device(tokens), self.pool.k, self.pool.v,
                self._row_table_dev, self._to_device(write_rows),
                self._to_device(starts),
            ), self._moe)
            return out[0], tally
        step = self._verify_graphs.get(tokens.shape[1])
        if step is None:
            # the closure holds what the graph binds, never the scheduler
            verify, params, pk, pv, moe = (
                self._verify, self.params, self.pool.k, self.pool.v, self._moe
            )

            def chain(tok, table, rows, lane_starts):
                out, tally = _split(verify(params, tok, pk, pv, table, rows, lane_starts), moe)
                return out[0], tally

            step = CapturedStep(chain, device=self.device, mempool=self._graph_pool)
            self._verify_graphs[tokens.shape[1]] = step
        return step(
            self._host_tensor(tokens), self._host_tensor(self._row_table),
            self._host_tensor(write_rows), self._host_tensor(starts),
        )

    def _spec_step(self) -> None:
        """One speculate-and-verify cycle over every decoding lane.

        The drafter proposes up to ``depth - 1`` tokens per lane; one
        batched ``verify_chunk_paged`` call then feeds each lane's pending
        token plus its proposals at the lane's own offset, writing their
        K/V rows and returning the target's logits at every chain
        position. Sampling position ``m`` with the plain decode's rng key
        (seed, rid, m) makes longest-accepted-prefix selection
        deterministic, and the output token-identical to plain decode,
        since each position's logits depend only on accepted tokens.
        Rejected rows cost nothing: ``end_draft`` returns the surplus
        blocks (owner="draft" in the ledger) and the stale rows are
        overwritten by the next chain before any unmasked read.
        """
        lanes = [(i, rid) for i, rid in enumerate(self.active) if self._decoding(rid)]
        if not lanes:
            return
        t0 = self.spans.now() if self.spans is not None else 0.0
        views: list[LaneDraft] = []
        k_eff: dict[int, int] = {}
        for i, rid in lanes:
            req = self.requests[rid]
            # never draft past the request's commitment: the chain ends at
            # row p + max_new - 1 at most, so begin_draft stays within the
            # admitted block budget
            k_eff[rid] = min(self.speculative.depth, req.max_new_tokens - len(req.output))
            views.append(LaneDraft(
                slot=i, rid=rid, pending=int(self._token[i, 0]),
                out_len=len(req.output), n_rows=int(self._lengths[i]),
                history=np.concatenate([req.prompt, np.asarray(req.output, np.int32)]),
            ))
        kmax = max(k_eff.values())
        props: dict[int, np.ndarray] = {}
        if kmax > 1:
            h0 = time.monotonic()
            proposed, draft_steps = self.speculative.propose(views, kmax, self.sampling)
            self.propose_s += time.monotonic() - h0
            for v, row in zip(views, proposed):
                props[v.rid] = row
            self.stats.draft_tokens += sum(k_eff[rid] - 1 for _, rid in lanes)
            if self.charge is not None and draft_steps:
                self.charge("draft", steps=draft_steps)
        t1 = self.spans.now() if self.spans is not None else t0
        # room for every lane's chain rows: draft-class blocks, settled (or
        # all returned) by end_draft after acceptance
        for i, rid in lanes:
            before = self.pool.blocks_held(rid)
            self.pool.begin_draft(rid, int(self._lengths[i]) + k_eff[rid])
            if self.pool.blocks_held(rid) != before:
                self._row_table[i] = self.pool.rows_of(rid, pad_to=self.s_max)
                self._table_dirty = True
        scratch = int(self.pool.scratch_rows(1)[0])
        tokens = np.zeros((self.slots, kmax), np.int32)
        write_rows = np.full((self.slots, kmax), scratch, np.int32)
        starts = np.zeros((self.slots,), np.int32)
        for i, rid in lanes:
            ke = k_eff[rid]
            n = int(self._lengths[i])
            tokens[i, 0] = self._token[i, 0]
            if ke > 1:
                tokens[i, 1:ke] = props[rid][: ke - 1]
            write_rows[i, :ke] = self.pool.rows_of(rid)[n : n + ke]
            starts[i] = n
        h0 = time.monotonic()
        logits, counts = self._run_verify(tokens, write_rows, starts)
        rows = self._host(logits)
        self._note_expert_counts(counts)
        self.verify_s += time.monotonic() - h0
        self.stats.verify_steps += 1
        self.verify_lengths[kmax] = self.verify_lengths.get(kmax, 0) + 1
        if self.charge is not None:
            # one weight sweep, and the chain's tokens beyond one a lane
            self.charge("verify", steps=1, tokens=sum(k_eff.values()) - len(lanes))
        t2 = self.spans.now() if self.spans is not None else t0
        if self.spans is not None:
            for i, rid in lanes:
                if kmax > 1:
                    self.spans.mark(rid, "draft", t0, t1, tokens=k_eff[rid] - 1)
                self.spans.mark(rid, "verify", t1, t2, depth=k_eff[rid])
        done_slots: list[int] = []
        for i, rid in lanes:
            req = self.requests[rid]
            ke = k_eff[rid]
            n0 = int(self._lengths[i])
            accepted = 0
            for j in range(ke):
                nxt = self._sample_one(req, rows[i, j])
                req.output.append(nxt)
                accepted += 1
                self._token[i, 0] = nxt
                if j < ke - 1 and nxt != int(props[rid][j]):
                    break  # the correction token is accepted, the chain's tail not
            self.stats.accepted_tokens += accepted
            self._lengths[i] = n0 + accepted
            before = self.pool.blocks_held(rid)
            self.pool.end_draft(rid, n0 + accepted)
            if self.pool.blocks_held(rid) != before:
                self._row_table[i] = self.pool.rows_of(rid, pad_to=self.s_max)
                self._table_dirty = True
            self.speculative.accept(i, n0 + accepted)
            if len(req.output) >= req.max_new_tokens:
                done_slots.append(i)
        # sample pool pressure with every accept settled but finished
        # requests still resident (the decode step's counterpart)
        pool_st = self.pool.stats()
        self.stats.shared_blocks_peak = max(
            self.stats.shared_blocks_peak, pool_st.shared_blocks
        )
        self.stats.util_samples_any.append(pool_st.utilization)
        if all(r is not None for r in self.active):
            self.stats.util_samples.append(pool_st.utilization)
        for i in done_slots:
            # completion lands exactly on the verify span's end
            self._complete(i, t2 if self.spans is not None else None)

    # ---------------- main loop ----------------

    def round(self) -> None:
        """One scheduler round: drain admissions, advance one chunk of any
        mid-prefill long prompt, then R_F decode steps (speculate-and-verify
        cycles when a drafter is installed)."""
        while self._admit_one():
            pass
        for i, rid in enumerate(self.active):
            if rid is not None and rid in self._chunk_cursor:
                self._prefill_one_chunk(i)
        step = self._spec_step if self.speculative is not None else self._decode_step
        t0 = time.monotonic()
        for _ in range(self.decode_per_round):
            if not any(self._decoding(r) for r in self.active):
                break
            step()
        self.stats.decode_time += time.monotonic() - t0
        if self.spans is not None and self._decode_open:
            # close still-running lanes' slices at the round's decode end
            t = self.spans.now()
            for rid, (ts, steps) in self._decode_open.items():
                self.spans.mark(rid, "decode", ts, t, steps=steps)
            self._decode_open.clear()
        self.stats.rounds += 1
        if self.mem_monitor is not None:
            self.mem_monitor.observe(
                t=self._mem_clock(),
                pool=self.pool,
                evicted_blocks=(
                    self.prefix_cache.evicted_blocks
                    if self.prefix_cache is not None
                    else 0
                ),
            )
        if self.tracker is not None or self.on_round is not None:
            self._emit_round()
        if self.spans is not None:
            self.spans.flush()

    # ---------------- observability ----------------

    def _emit_round(self) -> None:
        """One structured record per round (see ``runtime.tracker``), the
        reference's fields: counters as deltas against the previous
        emission (so work done outside ``round``, an import or a drain,
        lands in the next record), gauges at emission time. It goes to
        ``on_round`` when that is set, else to the tracker."""
        s = self.stats
        # mem-ledger barrier: fold un-evented note_tokens drift into one
        # sync record and flush the buffer before the gauge record, so
        # every mem record precedes the metrics record it integrates to
        if self.ledger is not None:
            self.ledger.sync()
            self.ledger.flush()
        rec: dict = {"round": s.rounds}
        for k in DELTA_KEYS:
            cur = getattr(s, k)
            rec[k] = cur - self._emit_base.get(k, 0)
            self._emit_base[k] = cur
        rec["ttfts"] = [round(t, 6) for t in s.ttfts[self._emit_ttft_base :]]
        self._emit_ttft_base = len(s.ttfts)
        rec["queued"] = len(self.queue)
        rec["queued_tokens"] = sum(r.total_tokens for r in self.queue)
        rec["active"] = sum(r is not None for r in self.active)
        rec["committed_tokens"] = self.committed_tokens
        rec["chunked_prefills"] = len(self._chunk_cursor)
        p = self.pool.stats()
        rec.update(
            pool_utilization=round(p.utilization, 4),
            pool_occupancy=round(p.occupancy, 4),
            pool_free_blocks=p.free_blocks,
            pool_held_blocks=p.held_blocks,
            pool_held_tokens=p.held_tokens,
            pool_committed_blocks=p.committed_blocks,
            pool_shared_blocks=p.shared_blocks,
            pool_cached_blocks=p.cached_blocks,
            pool_evictable_blocks=p.evictable_blocks,
            pool_alloc_blocks=self.pool.alloc_blocks,
            pool_freed_blocks=self.pool.freed_blocks,
            pool_cow_copies=self.pool.cow_copies,
        )
        if self.residency is not None:
            # the plan's gauges (plan arithmetic) and the cumulative
            # streamed bytes the trace export turns into a MiB/s track
            rp = self.residency
            rec.update(
                residency_resident_bytes=int(rp.resident_bytes),
                residency_streamed_bytes_per_step=round(
                    rp.streamed_bytes_per_step, 3
                ),
                residency_hbm_traffic_reduction=round(
                    rp.hbm_traffic_reduction, 4
                ),
                residency_streamed_mib=round(
                    s.decode_steps * rp.streamed_bytes_per_step / 2**20, 6
                ),
            )
        if self.prefix_cache is not None:
            c = self.prefix_cache.stats()
            rec.update(
                cache_nodes=c["nodes"],
                cache_anchors=c["anchors"],
                cache_evicted_blocks=c["evicted_blocks"],
            )
        if self._expert_counts is not None:
            rec.update(self.moe_gauges())
        if self.on_round is not None:
            self.on_round(rec)
        else:
            self.tracker.log_metrics(rec, step=s.rounds)

    def moe_gauges(self) -> dict:
        """The round record's MoE gauges over the cumulative (L, E) tally,
        as the reference computes them: the normalised load entropy (1.0 =
        balanced) and the share of routed tokens that hit a resident expert
        (1.0 without a plan); under a plan, the streamed experts and the
        share of them the routing has touched so far."""
        out = {}
        counts = self._expert_counts
        tot = float(counts.sum())
        if tot > 0:
            pe = counts.sum(axis=0) / tot
            ent = float(-(pe * np.log(np.maximum(pe, 1e-12))).sum())
            out["moe_expert_entropy"] = round(ent / math.log(max(2, self.cfg.n_experts)), 4)
            hot = (self._expert_resident if self._expert_resident is not None
                   else np.ones(counts.shape, bool))
            out["moe_hot_expert_fraction"] = round(float(counts[hot].sum()) / tot, 4)
        if self._expert_resident is not None:
            streamed = ~self._expert_resident
            n_streamed = int(streamed.sum())
            out["moe_streamed_experts"] = n_streamed
            out["moe_stream_mask_occupancy"] = round(
                float((counts[streamed] > 0).sum()) / max(1, n_streamed), 4
            )
        return out

    def run(self, max_rounds: int | None = None) -> SchedulerStats:
        """Drain the queue to empty and finish every in-flight request."""
        limit = max_rounds or 64 + sum(
            r.total_tokens for r in self.requests.values()
        )
        while self.queue or any(r is not None for r in self.active):
            if self.stats.rounds >= limit:
                raise RuntimeError(
                    f"scheduler failed to drain: {len(self.queue)} queued, "
                    f"{sum(r is not None for r in self.active)} active after "
                    f"{self.stats.rounds} rounds"
                )
            self.round()
        self.pool.validate()
        if self.ledger is not None:
            # releases after the last emitted round would otherwise sit in
            # the buffer; a trailing sync keeps the stream complete
            self.ledger.sync()
            self.ledger.flush()
        return self.stats

    def outputs(self) -> dict[int, list[int]]:
        return {rid: req.output for rid, req in self.requests.items()}
