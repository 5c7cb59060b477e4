"""Continuous-batching request scheduler over a shared KV pool.

Port of ``repro.runtime.scheduler`` for the dense family. Request
lifecycle: QUEUED -> PREFILL -> DECODE -> DONE. Admission is token-budget
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
budgeted step: the plan's streamed layers run their FFN through
``stream_matmul``, the rest the resident path; prefill stays resident.

Not ported yet: ``prefix_cache``, ``speculative``, ``handoff``,
``tracker``, ``spans`` and ``ledger`` (and with them the residency
plan's ledger records and per-round gauges).
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.gals import required_rf
from repro_torch.models.config import PORTED_FAMILIES, ModelConfig
from repro_torch.models.lm import LMParams, SamplingParams, sample_logits
from repro_torch.runtime.kv_pool import KVPool
from repro_torch.runtime.residency.plan import RuntimeResidencyPlan
from repro_torch.runtime.steps import (
    make_budgeted_paged_serve_step,
    make_chunk_prefill_step,
    make_paged_serve_step,
    make_pool_prefill_step,
)

class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


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


@dataclasses.dataclass
class SchedulerStats:
    completed: int = 0
    generated_tokens: int = 0
    prefill_steps: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    rounds: int = 0
    ttfts: list[float] = dataclasses.field(default_factory=list)
    util_samples: list[float] = dataclasses.field(default_factory=list)
    util_samples_any: list[float] = dataclasses.field(default_factory=list)
    decode_time: float = 0.0

    @property
    def mean_ttft(self) -> float:
        return sum(self.ttfts) / len(self.ttfts) if self.ttfts else 0.0

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
    ):
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"Scheduler: family {cfg.family!r} is not ported")
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.device = pool.device
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
        self._prefill = make_pool_prefill_step(cfg)
        self._chunk_prefill = make_chunk_prefill_step(cfg)
        # a residency plan sends decode through the budgeted step: its
        # streamed layers run the FFN through stream_matmul
        self.residency = residency
        self._decode = (
            make_budgeted_paged_serve_step(
                cfg, residency.layer_stream_mask(cfg), residency.stream_ahead
            )
            if residency is not None
            else make_paged_serve_step(cfg)
        )
        self._chunk_cursor: dict[int, int] = {}
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self.active: list[int | None] = [None] * slots
        self._token = np.zeros((slots, 1), np.int32)
        self._lengths = np.zeros((slots,), np.int32)
        # per-lane physical row tables, updated on admission / block growth
        # / completion; the device copy is re-uploaded only when dirty
        self._row_table = np.tile(pool.scratch_rows(self.s_max), (slots, 1))
        self._row_table_dev = self._to_device(self._row_table)
        self._table_dirty = False
        self._next_rid = 0
        self.stats = SchedulerStats()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    # ---------------- submission ----------------

    def submit(
        self, prompt: np.ndarray, max_new_tokens: int, *, rid: int | None = None
    ) -> int:
        """Queue a request. The sampler is keyed on (seed, rid, position),
        so a request's token stream does not depend on its lane."""
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
        return rid

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

    # ---------------- admission / prefill ----------------

    def _start_decode(self, slot: int, req: Request, first: int) -> None:
        """Move a fully-prefilled request onto its decode lane."""
        req.t_first_token = time.monotonic()
        self.stats.ttfts.append(req.ttft)
        req.output.append(first)
        req._enter(RequestState.DECODE)
        self._token[slot, 0] = first
        self._lengths[slot] = len(req.prompt)
        self._row_table[slot] = self.pool.rows_of(req.rid, pad_to=self.s_max)
        self._table_dirty = True
        if len(req.output) >= req.max_new_tokens:
            self._complete(slot)

    def _admit_one(self) -> bool:
        """Admit the head-of-queue request if resources allow.

        Prompts within ``prefill_chunk`` prefill in one bucketed step;
        longer prompts are admitted only when no other request holds
        budget, then stream through ``prefill_chunk``-sized rounds.
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
        self.pool.admit(req.rid, req.total_tokens)
        p = len(req.prompt)

        if p > self.prefill_chunk:
            self.active[slot] = req.rid
            self._chunk_cursor[req.rid] = 0
            self._prefill_one_chunk(slot)
            return True

        t = self.pool.block_tokens
        bucket = max(t, -(-p // t) * t)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :p] = req.prompt
        logits, ks, vs = self._prefill(
            self.params, self._to_device(padded), p - 1
        )
        self.pool.write_prefill(req.rid, ks[:, 0], vs[:, 0], n_tokens=p)
        self.stats.prefill_steps += 1
        self.stats.prefill_tokens += p
        first = self._sample_one(req, self._host(logits[0, 0]))
        self.active[slot] = req.rid
        self._start_decode(slot, req, first)
        return True

    def _prefill_one_chunk(self, slot: int) -> None:
        """Run one ``prefill_chunk``-sized piece of a long prompt, padded
        to the fixed chunk width with scratch rows."""
        rid = self.active[slot]
        req = self.requests[rid]
        c0 = self._chunk_cursor[rid]
        p = len(req.prompt)
        c = self.prefill_chunk
        n = min(c, p - c0)
        self.pool.note_tokens(rid, c0 + n)
        rows = self.pool.rows_of(rid)[c0 : c0 + n]
        row_table = self.pool.rows_of(rid, pad_to=self.s_max)[None]
        scratch = int(self.pool.scratch_rows(1)[0])
        write_rows = np.full((1, c), scratch, np.int32)
        write_rows[0, :n] = rows
        tokens = np.zeros((1, c), np.int32)
        tokens[0, :n] = req.prompt[c0 : c0 + n]
        logits, self.pool.k, self.pool.v = self._chunk_prefill(
            self.params,
            self._to_device(tokens),
            self.pool.k,
            self.pool.v,
            self._to_device(row_table),
            self._to_device(write_rows),
            c0,
            n - 1,
        )
        self.stats.prefill_steps += 1
        self.stats.prefill_tokens += n
        self._chunk_cursor[rid] = c0 + n
        if c0 + n >= p:
            del self._chunk_cursor[rid]
            first = self._sample_one(req, self._host(logits[0, 0]))
            self._start_decode(slot, req, first)

    def _complete(self, slot: int) -> None:
        rid = self.active[slot]
        req = self.requests[rid]
        req._enter(RequestState.DONE)
        self.pool.release(rid)
        self.active[slot] = None
        self._token[slot, 0] = 0
        self._lengths[slot] = 0
        self._row_table[slot] = self.pool.scratch_rows(self.s_max)
        self._table_dirty = True
        self.stats.completed += 1
        self.stats.generated_tokens += len(req.output)

    def _decoding(self, rid: int | None) -> bool:
        return rid is not None and self.requests[rid].state is RequestState.DECODE

    def _decode_step(self) -> None:
        for i, rid in enumerate(self.active):
            if not self._decoding(rid):
                continue  # empty lane, or a mid-chunked-prefill reservation
            before = self.pool.blocks_held(rid)
            self.pool.note_tokens(rid, int(self._lengths[i]) + 1)
            if self.pool.blocks_held(rid) != before:
                self._row_table[i] = self.pool.rows_of(rid, pad_to=self.s_max)
                self._table_dirty = True
        if self._table_dirty:
            self._row_table_dev = self._to_device(self._row_table)
            self._table_dirty = False
        logits, self.pool.k, self.pool.v = self._decode(
            self.params,
            self._to_device(self._token),
            self.pool.k,
            self.pool.v,
            self._row_table_dev,
            self._to_device(self._lengths),
        )
        self.stats.decode_steps += 1
        rows = self._host(logits[:, 0, :])
        util = self.pool.stats().utilization
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

    # ---------------- main loop ----------------

    def round(self) -> None:
        """One scheduler round: drain admissions, advance one chunk of any
        mid-prefill long prompt, then R_F decode steps."""
        while self._admit_one():
            pass
        for i, rid in enumerate(self.active):
            if rid is not None and rid in self._chunk_cursor:
                self._prefill_one_chunk(i)
        t0 = time.monotonic()
        for _ in range(self.decode_per_round):
            if not any(self._decoding(r) for r in self.active):
                break
            self._decode_step()
        self.stats.decode_time += time.monotonic() - t0
        self.stats.rounds += 1

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
        return self.stats

    def outputs(self) -> dict[int, list[int]]:
        return {rid: req.output for rid, req in self.requests.items()}
