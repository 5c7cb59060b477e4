"""JSONL serve traces -> Chrome/Perfetto ``trace_event`` JSON.

Port of ``repro.perf.trace_export`` (plain Python, copied).
``runtime.tracker.JsonlTracker`` streams interleave per-round metrics
records with per-request lifecycle spans (``runtime.spans``) and memory
ledger records (``runtime.memledger``). This module converts such a
stream into the Trace Event Format that https://ui.perfetto.dev and
``chrome://tracing`` open natively:

  * one *process* track per engine (pid = engine id; a single scheduler
    is engine 0),
  * one *thread* row per request (tid = rid) carrying its phase spans
    as complete ("X") events,
  * flow arrows ("s"/"f") for cross-engine motion (a handoff, a drain
    and requeue), where a stream has any,
  * counter ("C") tracks per engine from the round records' gauges
    (pool utilization/occupancy, cached and shared blocks, queue depth,
    active lanes, the speculative counters, streamed MiB/s from the
    cumulative residency gauge) and from the memory ledger's reserve
    records (the residency plan's reserved bytes).

Timestamps are microseconds (the trace_event unit).
``validate_trace_events`` checks the shape the viewers require.

CLI::

    python -m repro_torch.perf.trace_export serve_trace.jsonl \
        [-o serve_trace.perfetto.json] [--check]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Iterable

_US = 1e6  # seconds -> microseconds

# span attrs lifted into trace_event args (everything non-positional)
_SPAN_BASE = {"kind", "rid", "phase", "t0", "t1", "engine", "role"}


def _span_args(s: dict) -> dict:
    return {k: v for k, v in s.items() if k not in _SPAN_BASE}


def to_trace_events(records: Iterable[dict]) -> dict:
    """Convert a tracker record stream to a trace_event document."""
    records = list(records)
    events: list[dict] = []
    engines: dict[int, str] = {}
    for r in records:
        if r.get("kind") == "hparams" and r.get("surface") == "engine":
            engines[int(r["engine"])] = str(r.get("role", "both"))

    spans = [r for r in records if r.get("kind") == "span"]
    by_rid: dict[int, list[dict]] = {}
    for s in spans:
        by_rid.setdefault(int(s["rid"]), []).append(s)
    for ss in by_rid.values():
        ss.sort(key=lambda s: (s["t0"], s["t1"]))

    seen_pids: set[int] = set()
    for s in spans:
        pid = int(s.get("engine", 0))
        seen_pids.add(pid)
        events.append(
            {
                "ph": "X",
                "name": s["phase"],
                "cat": "span",
                "pid": pid,
                "tid": int(s["rid"]),
                "ts": s["t0"] * _US,
                "dur": (s["t1"] - s["t0"]) * _US,
                "args": _span_args(s),
            }
        )

    # process metadata: one named track per engine
    for pid in sorted(seen_pids | set(engines)):
        role = engines.get(pid, "both")
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "args": {"name": f"engine {pid} ({role})"},
            }
        )

    # flow arrows: handoff transit and drain->requeue motion
    flow_id = 0
    for rid, ss in sorted(by_rid.items()):
        for i, s in enumerate(ss):
            nxt = next(
                (
                    n
                    for n in ss[i + 1 :]
                    if n.get("engine") != s.get("engine")
                ),
                None,
            )
            arrow = None
            if s["phase"] == "handoff" and nxt is not None:
                arrow = "handoff"
            elif s.get("aborted") and nxt is not None:
                arrow = "requeue"
            if arrow is None:
                continue
            flow_id += 1
            common = {"cat": arrow, "name": arrow, "id": flow_id}
            events.append(
                {
                    "ph": "s",
                    "pid": int(s.get("engine", 0)),
                    "tid": rid,
                    "ts": s["t1"] * _US,
                    **common,
                }
            )
            events.append(
                {
                    "ph": "f",
                    "bp": "e",
                    "pid": int(nxt.get("engine", 0)),
                    "tid": rid,
                    "ts": nxt["t0"] * _US,
                    **common,
                }
            )

    # engine gauges from the round records as counter tracks
    counter_keys = (
        "pool_utilization",
        "pool_occupancy",
        "pool_cached_blocks",
        "pool_shared_blocks",
        "queued",
        "active",
        # speculative decode: per-round delta counters; viewed next to
        # the draft/verify spans the first two read as acceptance rate
        "accepted_tokens",
        "draft_tokens",
        "verify_steps",
    )
    streamed_prev: dict[int, tuple[float, float]] = {}  # pid -> (t, cum)
    # standalone round records carry no clock_s; the ledger flushes its
    # mem records (monotonic-stamped) right before each one, so the last
    # mem timestamp per engine is the round's counter timestamp
    last_mem_t: dict[int, float] = {}
    for r in records:
        kind = r.get("kind", "metrics")
        if kind == "mem" and "t" in r:
            last_mem_t[int(r.get("engine") or 0)] = float(r["t"])
            continue
        if kind != "metrics":
            continue
        pid = int(r.get("engine", 0))
        t = r.get("clock_s", last_mem_t.get(pid))
        if t is None:
            continue
        t = float(t)
        ts = t * _US
        for key in counter_keys:
            if key in r:
                events.append(
                    {
                        "ph": "C",
                        "name": key,
                        "pid": pid,
                        "ts": ts,
                        "args": {key: r[key]},
                    }
                )
        # streamed HBM bandwidth: the gauge is cumulative MiB, so the
        # rate is its per-round difference over the virtual clock
        if "residency_streamed_mib" in r:
            cum = float(r["residency_streamed_mib"])
            prev = streamed_prev.get(pid)
            rate = 0.0
            if prev is not None and t > prev[0]:
                rate = max(0.0, (cum - prev[1]) / (t - prev[0]))
            streamed_prev[pid] = (t, cum)
            events.append(
                {
                    "ph": "C",
                    "name": "streamed_hbm_mib_per_s",
                    "pid": pid,
                    "ts": ts,
                    "args": {"streamed_hbm_mib_per_s": round(rate, 3)},
                }
            )

    # VMEM-resident bytes: integrate the ledger's static reservations
    # (weight-resident plan + expert stream ring) per engine
    vmem: dict[int, int] = {}
    for r in records:
        if r.get("kind") != "mem" or r.get("op") != "reserve":
            continue
        pid = int(r.get("engine") or 0)
        vmem[pid] = vmem.get(pid, 0) + int(r.get("nbytes", 0))
        events.append(
            {
                "ph": "C",
                "name": "vmem_resident_bytes",
                "pid": pid,
                "ts": float(r.get("t", 0.0)) * _US,
                "args": {"vmem_resident_bytes": vmem[pid]},
            }
        )

    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_trace_events(doc: dict) -> list[str]:
    """Shape checks against the trace_event format. Empty == loadable."""
    errors: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be an object with a 'traceEvents' list"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    flows: dict[object, list[str]] = {}
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M", "C", "s", "f", "i", "b", "e"):
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if "name" not in e:
            errors.append(f"{where}: missing name")
        if ph != "M" and not isinstance(e.get("ts"), (int, float)):
            errors.append(f"{where}: ph={ph} needs a numeric ts")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs dur >= 0, got {dur!r}")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(f"{where}: C event needs non-empty args")
            elif not all(isinstance(v, (int, float)) for v in args.values()):
                errors.append(f"{where}: C event args must be numeric")
        if ph in ("s", "f"):
            if "id" not in e:
                errors.append(f"{where}: flow event needs an id")
            else:
                flows.setdefault(e["id"], []).append(ph)
    for fid, phs in sorted(flows.items(), key=lambda kv: str(kv[0])):
        if sorted(phs) != ["f", "s"]:
            errors.append(f"flow id {fid!r}: unpaired steps {phs}")
    return errors


def main(argv=None) -> int:
    from repro_torch.runtime.tracker import read_jsonl

    ap = argparse.ArgumentParser(
        description="Convert a JSONL serve trace to Perfetto trace_event "
        "JSON (open at https://ui.perfetto.dev)."
    )
    ap.add_argument("trace", help="JsonlTracker stream (one object/line)")
    ap.add_argument(
        "-o",
        "--out",
        default=None,
        help="output path (default: <trace>.perfetto.json)",
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="validate the exported document; non-zero exit on errors",
    )
    args = ap.parse_args(argv)

    records = read_jsonl(args.trace)
    doc = to_trace_events(records)
    out = Path(
        args.out
        if args.out is not None
        else str(Path(args.trace).with_suffix("")) + ".perfetto.json"
    )
    out.write_text(json.dumps(doc) + "\n")
    n_spans = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
    n_flows = sum(1 for e in doc["traceEvents"] if e["ph"] == "s")
    n_counters = sum(1 for e in doc["traceEvents"] if e["ph"] == "C")
    print(
        f"{out}: {len(doc['traceEvents'])} events "
        f"({n_spans} spans, {n_flows} flows, {n_counters} counters)"
    )
    if args.check:
        errors = validate_trace_events(doc)
        # a stream with timestampable round records must yield counter
        # tracks — a silent counter regression would strand the memory
        # telemetry (metrics records are timestamped by clock_s or by
        # the mem records flushed just before them)
        has_mem = any(r.get("kind") == "mem" for r in records)
        has_rounds = any(
            r.get("kind", "metrics") == "metrics"
            and ("clock_s" in r or has_mem)
            for r in records
        )
        if has_rounds and n_counters == 0:
            errors.append("metrics records present but no counter events")
        for err in errors:
            print(f"INVALID: {err}")
        if errors:
            return 1
        print("trace_event shape: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
