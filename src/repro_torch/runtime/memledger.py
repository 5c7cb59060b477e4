"""Event-sourced memory ledger: byte-exact KV-pool and residency telemetry.

Port of ``repro.runtime.memledger`` (plain Python, copied). The span
recorder (``runtime.spans``) gives an exact *time* decomposition; this
module is the *memory* counterpart. Every KV-pool mutation — ``admit`` /
block growth in ``ensure_rows`` / ``adopt_prefix`` (with its
copy-on-write) / ``release`` / ``retain_cached`` / ``uncache`` / the
prefix cache's ``evict`` — emits a ``kind="mem"`` delta record through
the tracker backends, interleaved with round metrics and spans on one
JSONL stream. Static owners (the residency plan's resident FFN tiles and
its stream ring) emit ``op="reserve"`` records, so the byte attribution
covers more than the KV pool. Speculative decoding's draft brackets emit
``draft_grow`` / ``draft_end`` records under ``owner="draft"``.

Record schema (``kind="mem"``)::

    {"kind": "mem", "op": "admit", "owner": "request", "rid": 3,
     "t": 12.25, "d_held_blocks": 2, "d_held_tokens": 7,
     "d_free_blocks": -2, "d_alloc_blocks": 2, "d_bytes": 98304}

``op="attach"`` records carry *absolute* gauges plus pool geometry
(``n_blocks``, ``block_tokens``, ``block_bytes``) and reset the
integration state for that engine id. All other records carry sparse
``d_``-prefixed deltas against the previous snapshot of the same pool,
which makes the exactness contract hold *by construction*:

    integrating the deltas from the last ``attach`` reproduces every
    ``PoolStats`` gauge in every round-metrics record int-exact, and the
    derived floats (Eq.-1 ``pool_utilization``, ``pool_occupancy``)
    round-exact — ``validate_ledger`` asserts this over a full trace.

``MemPressureMonitor`` consumes the same gauges as a streaming signal:
occupancy burn rates against a ``MemPolicy`` target over multiple
windows (mirroring ``SLOMonitor``), eviction-storm detection, a
fragmentation trend, and a ``fragmentation_report()`` snapshot captured
at the occupancy peak.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

from repro_torch.runtime.spans import NDIGITS, StreamingHist, _r6

__all__ = [
    "MemLedger",
    "MemPolicy",
    "MemPressureMonitor",
    "kv_block_bytes",
    "summarize_ledger",
    "validate_ledger",
]

#: Integrated gauge vector. Every ``d_<key>`` delta and every ``attach``
#: absolute refers to one of these; ``validate_ledger`` checks each against
#: the ``pool_<key>`` gauge of round-metrics records.
GAUGES = (
    "held_blocks",
    "held_tokens",
    "free_blocks",
    "committed_blocks",
    "shared_blocks",
    "cached_blocks",
    "evictable_blocks",
    "alloc_blocks",
    "freed_blocks",
    "cow_copies",
)


def kv_block_bytes(pool) -> int:
    """Bytes of KV cache backing one pool block (both K and V planes).

    The pool arrays are row-addressed (L, n_blocks * block_tokens, n_kv,
    hd); a block is ``block_tokens`` rows of both planes.
    """
    k = pool.k
    layers, _, n_kv, hd = k.shape
    return k.element_size() * layers * pool.block_tokens * n_kv * hd * 2


def _snapshot(pool) -> dict:
    s = pool.stats()
    return {
        "held_blocks": s.held_blocks,
        "held_tokens": s.held_tokens,
        "free_blocks": s.free_blocks,
        "committed_blocks": s.committed_blocks,
        "shared_blocks": s.shared_blocks,
        "cached_blocks": s.cached_blocks,
        "evictable_blocks": s.evictable_blocks,
        "alloc_blocks": pool.alloc_blocks,
        "freed_blocks": pool.freed_blocks,
        "cow_copies": pool.cow_copies,
    }


class MemLedger:
    """Buffered ``kind="mem"`` record emitter for one KV pool.

    Mirrors ``SpanRecorder``: stamped with engine/role, timestamped from a
    shared clock callable, buffered until ``flush()`` hands the batch to
    ``tracker.log_mem``. With no tracker, records are counted and dropped
    (the snapshot diffing still runs so a late ``attach`` stays exact).

    The scheduler calls ``sync()`` + ``flush()`` at the *top* of its round
    emission, before the metrics record is built — ``sync`` folds the
    ``note_tokens``-driven ``held_tokens`` drift (which deliberately does
    not emit per decode step) into one residual record, so integration is
    exact at every round boundary without a per-token record flood.
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
        self.pool = None
        self.block_bytes = 0
        self._base: dict | None = None
        self._buf: list[dict] = []
        self.n_records = 0
        self.n_dropped = 0

    # ------------------------------------------------------------ emission

    def now(self) -> float:
        return round(float(self._clock()), NDIGITS)

    def attach(self, pool) -> None:
        """Bind to ``pool`` and emit the absolute-gauge baseline record."""
        self.pool = pool
        pool.ledger = self
        self.block_bytes = kv_block_bytes(pool)
        self._base = _snapshot(pool)
        rec = {
            "op": "attach",
            "owner": "pool",
            "t": self.now(),
            "n_blocks": pool.usable_blocks,
            "block_tokens": pool.block_tokens,
            "block_bytes": self.block_bytes,
            **self._base,
        }
        self._emit(rec)

    def record(self, op: str, *, owner: str, **attrs) -> None:
        """Diff the pool against the last snapshot and emit the deltas.

        Called from inside the pool's mutating methods; nested emissions
        (an eviction triggered mid-``ensure_rows``) stay exact because
        each record diffs against the snapshot the previous one left.
        """
        if self.pool is None:
            return
        cur = _snapshot(self.pool)
        rec = {"op": op, "owner": owner, "t": self.now()}
        rec.update({k: v for k, v in attrs.items() if v is not None})
        changed = False
        for key in GAUGES:
            d = cur[key] - self._base[key]
            if d:
                rec["d_" + key] = d
                changed = True
        d_bytes = (
            (cur["alloc_blocks"] - self._base["alloc_blocks"])
            - (cur["freed_blocks"] - self._base["freed_blocks"])
        ) * self.block_bytes
        if d_bytes:
            rec["d_bytes"] = d_bytes
        self._base = cur
        if not changed and op == "sync":
            return  # nothing drifted since the last event
        self._emit(rec)

    def sync(self) -> None:
        """Emit a residual record folding un-evented gauge drift."""
        self.record("sync", owner="pool")

    def reserve(self, owner: str, nbytes: int, **attrs) -> None:
        """Static byte reservation (weight-resident VMEM, stream ring).

        Carries ``nbytes`` rather than ``d_`` deltas: reserve records
        attribute non-pool memory and are ignored by gauge integration.
        """
        rec = {"op": "reserve", "owner": owner, "t": self.now(), "nbytes": int(nbytes)}
        rec.update({k: v for k, v in attrs.items() if v is not None})
        self._emit(rec)

    def _emit(self, rec: dict) -> None:
        if self.engine is not None:
            rec["engine"] = self.engine
        if self.role is not None:
            rec["role"] = self.role
        self.n_records += 1
        if self.tracker is None:
            self.n_dropped += 1
            return
        self._buf.append(rec)

    def flush(self) -> None:
        if self._buf and self.tracker is not None:
            self.tracker.log_mem(self._buf)
        self._buf = []


# ---------------------------------------------------------------- validation


_METRIC_TO_GAUGE = {
    "pool_held_blocks": "held_blocks",
    "pool_held_tokens": "held_tokens",
    "pool_free_blocks": "free_blocks",
    "pool_committed_blocks": "committed_blocks",
    "pool_shared_blocks": "shared_blocks",
    "pool_cached_blocks": "cached_blocks",
    "pool_evictable_blocks": "evictable_blocks",
    "pool_alloc_blocks": "alloc_blocks",
    "pool_freed_blocks": "freed_blocks",
    "pool_cow_copies": "cow_copies",
}


def validate_ledger(records: list[dict]) -> list[str]:
    """Check the ledger exactness contract over an interleaved stream.

    Walks metrics + mem records in arrival order, integrating ``d_``
    deltas per engine id (an ``attach`` resets that engine's state — pool
    ids may be reused across pools). At every round-metrics record
    carrying pool gauges, the integrated state must match int-exact, and
    the derived ``pool_utilization`` / ``pool_occupancy`` floats must
    match their 4-digit roundings computed from integrated integers.
    Returns a list of error strings; empty means the contract holds.
    """
    errors: list[str] = []
    state: dict = {}  # engine id -> integrated gauges
    geom: dict = {}  # engine id -> (n_blocks, block_tokens)
    n_mem = 0
    for i, r in enumerate(records):
        kind = r.get("kind", "metrics")
        eng = r.get("engine")
        if kind == "mem":
            n_mem += 1
            op = r.get("op")
            if op == "attach":
                missing = [k for k in GAUGES if k not in r]
                if missing:
                    errors.append(f"record {i}: attach missing gauges {missing}")
                    continue
                state[eng] = {k: r[k] for k in GAUGES}
                geom[eng] = (r.get("n_blocks", 0), r.get("block_tokens", 1))
                continue
            if op == "reserve":
                continue  # static owner; no pool-gauge deltas
            st = state.get(eng)
            if st is None:
                errors.append(
                    f"record {i}: mem op={op!r} for engine {eng!r} before attach"
                )
                continue
            for key in GAUGES:
                st[key] += r.get("d_" + key, 0)
        elif kind == "metrics" and "pool_held_blocks" in r:
            st = state.get(eng)
            if st is None:
                errors.append(
                    f"record {i}: pool gauges for engine {eng!r} before attach"
                )
                continue
            for mk, gk in _METRIC_TO_GAUGE.items():
                if mk in r and r[mk] != st[gk]:
                    errors.append(
                        f"record {i}: engine {eng!r} {mk}={r[mk]} != "
                        f"integrated {gk}={st[gk]}"
                    )
            n_blocks, block_tokens = geom[eng]
            hb, ht = st["held_blocks"], st["held_tokens"]
            util = 1.0 if hb == 0 else ht / (hb * block_tokens)
            if "pool_utilization" in r and r["pool_utilization"] != round(util, 4):
                errors.append(
                    f"record {i}: engine {eng!r} pool_utilization="
                    f"{r['pool_utilization']} != {round(util, 4)}"
                )
            occ = hb / max(1, n_blocks)
            if "pool_occupancy" in r and r["pool_occupancy"] != round(occ, 4):
                errors.append(
                    f"record {i}: engine {eng!r} pool_occupancy="
                    f"{r['pool_occupancy']} != {round(occ, 4)}"
                )
    if n_mem == 0:
        errors.append("stream has no kind='mem' records (ledger never attached?)")
    return errors


def summarize_ledger(records: list[dict]) -> dict:
    """Owner attribution over a stream: peaks, churn, bytes, reserves.

    Feeds ``report.py mem``. Walks the stream integrating per-engine
    gauges; at each engine's occupancy peak it freezes the owner split
    (request-held vs prefix-cache-held blocks overlap — cached blocks a
    live request shares are counted in both columns, matching Eq. 1's
    shared-counted-once convention at the pool level).
    """
    per: dict = {}
    for r in records:
        if r.get("kind", "metrics") != "mem":
            continue
        eng = r.get("engine")
        op = r.get("op")
        e = per.setdefault(
            eng,
            {
                "engine": eng,
                "n_blocks": 0,
                "block_bytes": 0,
                "state": dict.fromkeys(GAUGES, 0),
                "peak_held_blocks": 0,
                "peak_t": 0.0,
                "peak_cached_blocks": 0,
                "peak_evictable_blocks": 0,
                "peak_shared_blocks": 0,
                "evicted_blocks": 0,
                "n_records": 0,
                "reserved_bytes": {},
            },
        )
        e["n_records"] += 1
        if op == "attach":
            e["state"] = {k: r[k] for k in GAUGES}
            e["n_blocks"] = max(e["n_blocks"], r.get("n_blocks", 0))
            e["block_bytes"] = r.get("block_bytes", e["block_bytes"])
            continue
        if op == "reserve":
            owner = r.get("owner", "?")
            e["reserved_bytes"][owner] = e["reserved_bytes"].get(owner, 0) + r.get(
                "nbytes", 0
            )
            continue
        st = e["state"]
        for key in GAUGES:
            st[key] += r.get("d_" + key, 0)
        if op == "evict":
            e["evicted_blocks"] += r.get("freed", 0)
        if st["held_blocks"] > e["peak_held_blocks"]:
            e["peak_held_blocks"] = st["held_blocks"]
            e["peak_t"] = r.get("t", 0.0)
            e["peak_cached_blocks"] = st["cached_blocks"]
            e["peak_evictable_blocks"] = st["evictable_blocks"]
            e["peak_shared_blocks"] = st["shared_blocks"]
    out = []
    for eng in sorted(per, key=lambda x: (x is None, x)):
        e = per[eng]
        st = e.pop("state")
        nb = max(1, e["n_blocks"])
        e["peak_occupancy"] = round(e["peak_held_blocks"] / nb, 4)
        e["alloc_blocks"] = st["alloc_blocks"]
        e["freed_blocks"] = st["freed_blocks"]
        e["cow_copies"] = st["cow_copies"]
        e["alloc_mib"] = _r6(st["alloc_blocks"] * e["block_bytes"] / 2**20)
        out.append(e)
    return {"engines": out}


# ------------------------------------------------------------- pressure


@dataclasses.dataclass(frozen=True)
class MemPolicy:
    """Memory-pressure target, the analogue of ``SloPolicy`` for bytes.

    ``max_occupancy`` is the pool-occupancy ceiling a round should stay
    under; ``target`` is the fraction of rounds that must respect it (so
    the error budget is ``1 - target`` and burn rates read like SLO burn
    rates: >1.0 means the budget is being spent faster than sustainable).
    ``storm_fraction`` flags an eviction storm when more than that
    fraction of the pool is evicted inside the shortest window;
    ``frag_drop`` flags a fragmentation trend when short-window mean
    Eq.-1 utilization drops that far below the long-window mean.
    """

    max_occupancy: float = 0.90
    target: float = 0.95
    storm_fraction: float = 0.5
    frag_drop: float = 0.15


class MemPressureMonitor:
    """Streaming memory-pressure signal over multi-window burn rates.

    Fed once per scheduler round with the live pool; keeps O(window)
    state. ``signal()`` collapses to ``"ok"`` / ``"pressure"`` /
    ``"storm"`` — an admission/scale input.
    """

    MAX_EVENTS = 100_000

    def __init__(self, policy: MemPolicy | None = None, windows=(60.0, 300.0, 900.0)):
        self.policy = policy or MemPolicy()
        self.windows = tuple(windows)
        self._events: deque = deque(maxlen=self.MAX_EVENTS)  # (t, ok)
        self._evict: deque = deque(maxlen=self.MAX_EVENTS)  # (t, cumulative)
        self._util: deque = deque(maxlen=self.MAX_EVENTS)  # (t, utilization)
        self.occ_hist = StreamingHist(lo=1e-4, hi=1.0)
        self.observed = 0
        self.violations = 0
        self.peak_held_blocks = 0
        self.peak_occupancy = 0.0
        self.peak_t = 0.0
        self.frag_at_peak: dict | None = None
        self.headroom_blocks = 0
        self.evicted_blocks = 0
        self._n_blocks = 0

    def observe(self, *, t: float, pool, evicted_blocks: int = 0) -> None:
        s = pool.stats()
        self.observed += 1
        ok = s.occupancy <= self.policy.max_occupancy
        if not ok:
            self.violations += 1
        self._events.append((t, ok))
        self._evict.append((t, evicted_blocks))
        self._util.append((t, s.utilization))
        self.occ_hist.add(max(s.occupancy, 1e-4))
        self.headroom_blocks = s.free_blocks + s.evictable_blocks
        self.evicted_blocks = evicted_blocks
        self._n_blocks = s.n_blocks
        if s.held_blocks > self.peak_held_blocks:
            self.peak_held_blocks = s.held_blocks
            self.peak_occupancy = s.occupancy
            self.peak_t = t
            self.frag_at_peak = pool.fragmentation_report()

    # ---------------------------------------------------------- windows

    def burn_rates(self, now: float) -> dict[str, float]:
        """Occupancy-budget burn per window; >1.0 burns faster than target."""
        budget = max(1e-9, 1.0 - self.policy.target)
        out = {}
        for w in self.windows:
            lo = now - w
            n = bad = 0
            for t, ok in reversed(self._events):
                if t < lo:
                    break
                n += 1
                bad += not ok
            out[f"{int(w)}s"] = _r6(bad / n / budget) if n else 0.0
        return out

    def eviction_rates(self, now: float) -> dict[str, int]:
        """Blocks evicted inside each window (from cumulative samples)."""
        out = {}
        for w in self.windows:
            lo = now - w
            newest = oldest = None
            for t, cum in reversed(self._evict):
                if t < lo:
                    break
                if newest is None:
                    newest = cum
                oldest = cum
            out[f"{int(w)}s"] = (newest - oldest) if newest is not None else 0
        return out

    def frag_trend(self, now: float) -> dict:
        """Short- vs long-window mean Eq.-1 utilization drift."""
        short_w, long_w = min(self.windows), max(self.windows)
        sums = {short_w: [0.0, 0], long_w: [0.0, 0]}
        for t, u in reversed(self._util):
            if t < now - long_w:
                break
            sums[long_w][0] += u
            sums[long_w][1] += 1
            if t >= now - short_w:
                sums[short_w][0] += u
                sums[short_w][1] += 1
        short = sums[short_w][0] / sums[short_w][1] if sums[short_w][1] else 1.0
        long = sums[long_w][0] / sums[long_w][1] if sums[long_w][1] else 1.0
        return {
            "short_utilization": _r6(short),
            "long_utilization": _r6(long),
            "degrading": short < long - self.policy.frag_drop,
        }

    def signal(self, now: float) -> str:
        shortest = f"{int(min(self.windows))}s"
        if self._n_blocks and (
            self.eviction_rates(now)[shortest]
            > self.policy.storm_fraction * self._n_blocks
        ):
            return "storm"
        if self.burn_rates(now)[shortest] > 1.0:
            return "pressure"
        return "ok"

    def summary(self, now: float | None = None) -> dict:
        out = {
            "observed": self.observed,
            "violations": self.violations,
            "policy": dataclasses.asdict(self.policy),
            "peak_held_blocks": self.peak_held_blocks,
            "peak_occupancy": _r6(self.peak_occupancy),
            "peak_t": _r6(self.peak_t),
            "headroom_blocks": self.headroom_blocks,
            "evicted_blocks": self.evicted_blocks,
            "occupancy": self.occ_hist.summary(),
            "frag_at_peak": self.frag_at_peak,
        }
        if now is not None:
            out["burn_rates"] = self.burn_rates(now)
            out["eviction_rates"] = self.eviction_rates(now)
            out["frag_trend"] = self.frag_trend(now)
            out["signal"] = self.signal(now)
        return out
