"""Serve observability: one tracker, one record per scheduler round.

Port of ``repro.runtime.tracker`` (plain Python over numpy, copied). Every
scheduler round emits exactly one structured record that merges the
scheduler's counter *deltas* since the previous record with the KV pool's
*gauges* at emission time. The interface is levanter's tracker shape:
``log_hyperparameters`` once per run, step-keyed ``log_metrics`` per round,
``finish`` at shutdown. Backends: ``JsonlTracker`` (one JSON object per
line), ``MemoryTracker`` (tests and in-process replay checks),
``NullTracker`` (explicit no-op) and ``CompositeTracker`` (fan-out).

Because per-round counters are emitted as deltas, the stream is
*replayable*: summing a run's records (``replay_summary``) reproduces the
scheduler's totals exactly, so a trace is a complete account of the run.

Record schema (``kind="metrics"``, one per round):

    round                 scheduler round index (the step key)
    queued/queued_tokens  intake backlog at end of round   [gauge]
    active                busy decode lanes                [gauge]
    committed_tokens      admitted token commitment        [gauge]
    chunked_prefills      prompts mid chunked prefill      [gauge]
    prefill_steps/_tokens, decode_steps, generated_tokens,
    completed, handoffs, prefix_hits, prefix_hit_tokens,
    expert_tokens, accepted_tokens, draft_tokens,
    verify_steps                                           [deltas]
    ttfts                 wall-clock TTFTs recorded this round
    pool_*                KVPool gauges (utilization, occupancy, free/
                          held/committed/shared/cached/evictable blocks)
                          + cumulative alloc/freed/cow counters
    residency_*           the residency plan's gauges (budgeted decode)
    cache_*               the prefix cache's nodes, anchors and evicted
                          blocks (with a cache attached)

The port's scheduler runs neither MoE nor prefill/decode handoff yet, so
their deltas stay 0, as the reference reports them on a run without those
features.

A second record kind, ``kind="span"`` (emitted via ``log_spans`` by
``runtime.spans.SpanRecorder``), interleaves per-request lifecycle spans
— {rid, phase, t0, t1, attrs...} — in the same stream; ``replay_summary``
ignores them and ``runtime.spans.validate_trace`` checks their
exact-decomposition contract.

A third kind, ``kind="mem"`` (emitted via ``log_mem`` by
``runtime.memledger.MemLedger``), interleaves event-sourced KV-pool
mutation deltas — {op, owner, t, d_held_blocks, d_bytes, ...} — plus
``op="attach"`` absolute baselines and ``op="reserve"`` static byte
reservations (the residency plan's resident FFN tiles and its stream
ring). ``replay_summary`` ignores them;
``runtime.memledger.validate_ledger`` checks their integration contract
against the per-round pool gauges.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np


def jsonable(obj: Any) -> Any:
    """Recursively coerce numpy scalars/arrays and tuples for json."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    return str(obj)


class Tracker:
    """Interface: ``log_hyperparameters`` once, ``log_metrics`` per step."""

    def log_hyperparameters(self, hparams: dict) -> None:
        raise NotImplementedError

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        raise NotImplementedError

    def log_spans(self, spans: list[dict]) -> None:
        # optional: per-request lifecycle spans (runtime.spans). Default
        # no-op so pre-span backends keep working unchanged.
        pass

    def log_mem(self, records: list[dict]) -> None:
        # optional: memory-ledger deltas (runtime.memledger). Default
        # no-op so pre-ledger backends keep working unchanged.
        pass

    def finish(self) -> None:  # optional flush/close
        pass


class NullTracker(Tracker):
    """Discards everything (the default for tests and bare schedulers)."""

    def log_hyperparameters(self, hparams: dict) -> None:
        pass

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        pass


class MemoryTracker(Tracker):
    """Keeps records in-process: replay checks without file round-trips."""

    def __init__(self):
        self.hparams: list[dict] = []
        self.records: list[dict] = []
        self.spans: list[dict] = []
        self.mems: list[dict] = []
        # every record in arrival order, kind-tagged — in-process tests
        # validate cross-kind interleaving (mem-before-metrics ordering,
        # full-stream ledger integration) without a file round-trip
        self.stream: list[dict] = []

    def log_hyperparameters(self, hparams: dict) -> None:
        self.hparams.append(dict(hparams))
        self.stream.append({"kind": "hparams", **hparams})

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        rec = {**metrics, "step": step}
        self.records.append(rec)
        self.stream.append({"kind": "metrics", **rec})

    def log_spans(self, spans: list[dict]) -> None:
        tagged = [{"kind": "span", **s} for s in spans]
        self.spans.extend(tagged)
        self.stream.extend(tagged)

    def log_mem(self, records: list[dict]) -> None:
        tagged = [{"kind": "mem", **m} for m in records]
        self.mems.extend(tagged)
        self.stream.extend(tagged)


class JsonlTracker(Tracker):
    """Appends one JSON object per line to ``path``.

    Lines carry ``kind`` ("hparams" or "metrics") so a mixed stream from
    several engines sharing one tracker stays self-describing.
    """

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        self.n_records = 0

    def log_hyperparameters(self, hparams: dict) -> None:
        self._write({"kind": "hparams", **jsonable(hparams)})

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        self._write({"kind": "metrics", "step": step, **jsonable(metrics)})
        self.n_records += 1

    def log_spans(self, spans: list[dict]) -> None:
        for s in spans:
            self._write({"kind": "span", **jsonable(s)})

    def log_mem(self, records: list[dict]) -> None:
        for m in records:
            self._write({"kind": "mem", **jsonable(m)})

    def _write(self, obj: dict) -> None:
        self._fh.write(json.dumps(obj) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        self._fh.close()


class CompositeTracker(Tracker):
    """Fans every call out to several backends."""

    def __init__(self, *trackers: Tracker):
        self.trackers = trackers

    def log_hyperparameters(self, hparams: dict) -> None:
        for t in self.trackers:
            t.log_hyperparameters(hparams)

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        for t in self.trackers:
            t.log_metrics(metrics, step=step)

    def log_spans(self, spans: list[dict]) -> None:
        for t in self.trackers:
            t.log_spans(spans)

    def log_mem(self, records: list[dict]) -> None:
        for t in self.trackers:
            t.log_mem(records)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


def read_jsonl(path) -> list[dict]:
    """Load a ``JsonlTracker`` stream back into records."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# counter keys whose per-round values are deltas (summable on replay)
DELTA_KEYS = (
    "prefill_steps",
    "prefill_tokens",
    "decode_steps",
    "generated_tokens",
    "completed",
    "handoffs",
    "prefix_hits",
    "prefix_hit_tokens",
    "expert_tokens",
    "accepted_tokens",
    "draft_tokens",
    "verify_steps",
)

# SchedulerStats fields that are deliberately NOT replayed as deltas:
# round counts are the record count itself, ttfts ride their own list,
# util samples / peaks / wall decode time are gauges or derived values.
# Everything else on SchedulerStats MUST be in DELTA_KEYS — see
# ``delta_coverage_gaps`` (the drift guard that makes a new counter
# field a named test failure instead of a silent replay mismatch).
NON_DELTA_STATS_FIELDS = frozenset(
    {
        "rounds",
        "ttfts",
        "util_samples",
        "util_samples_any",
        "shared_blocks_peak",
        "decode_time",
    }
)


def delta_coverage_gaps(stats_cls=None) -> list[str]:
    """Names of ``SchedulerStats`` fields covered by neither DELTA_KEYS
    nor the declared non-delta exemptions. Non-empty means a stats field
    was added without extending the replay contract."""
    import dataclasses

    if stats_cls is None:
        from repro_torch.runtime.scheduler import SchedulerStats as stats_cls
    return [
        f.name
        for f in dataclasses.fields(stats_cls)
        if f.name not in DELTA_KEYS and f.name not in NON_DELTA_STATS_FIELDS
    ]


def replay_summary(records: list[dict], engine: int | None = None) -> dict:
    """Reconstruct run totals from a metrics stream.

    Sums the delta counters (and concatenates TTFT events) across the
    selected records; the result must equal the live
    ``SchedulerStats`` totals — the tracker's
    conservation property. ``engine`` filters a multi-engine stream.
    """
    rows = [
        r
        for r in records
        if r.get("kind", "metrics") == "metrics"
        and (engine is None or r.get("engine") == engine)
    ]
    out: dict = {k: 0 for k in DELTA_KEYS}
    ttfts: list[float] = []
    for r in rows:
        for k in DELTA_KEYS:
            out[k] += r.get(k, 0)
        ttfts.extend(r.get("ttfts", ()))
    out["rounds"] = len(rows)
    out["ttfts"] = ttfts
    out["mean_ttft"] = sum(ttfts) / len(ttfts) if ttfts else 0.0
    if rows:
        last = rows[-1]
        for k in (
            "clock_s",
            "pool_utilization",
            "pool_cached_blocks",
            "moe_expert_entropy",
            "moe_hot_expert_fraction",
        ):
            if k in last:
                out[k] = last[k]
    return out
