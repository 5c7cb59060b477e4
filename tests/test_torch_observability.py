"""Port parity for the serve path's observability: the port's scheduler and
the reference's on the same weights and submitted trace, each with a
tracker, a span recorder and a memory ledger on a deterministic counter
clock, give the same round, span and ledger records; the port's records
replay to its live counters and pass the reference's validators; the
pool's reports, the residency records and the trace export agree with
the reference's; and the CPU serve entry point writes a trace that
exports."""

import dataclasses
import itertools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.perf import trace_export as j_export  # noqa: E402
from repro.runtime import memledger as j_mem  # noqa: E402
from repro.runtime import spans as j_spans  # noqa: E402
from repro.runtime import tracker as j_tracker  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.residency import plan as jplan  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.perf import trace_export as t_export  # noqa: E402
from repro_torch.runtime import memledger as t_mem  # noqa: E402
from repro_torch.runtime import spans as t_spans  # noqa: E402
from repro_torch.runtime import tracker as t_tracker  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.residency import plan as tplan  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402
from repro_torch.runtime.scheduler import SchedulerStats as TStats  # noqa: E402

SLOTS, MAX_LEN, BLOCK, CHUNK = 3, 40, 4, 12
# 17 and 30 exceed the prefill chunk and prefill in chunks (30's third
# chunk in a later round); the 1-token request completes the instant its
# prefill ends
PROMPT_LENS = (5, 17, 9, 3, 30, 12, 7)
GEN = (6, 4, 8, 1, 3, 7, 5)
STAMPS = ("t0", "t1")  # span clock stamps
WALL = ("t",)  # ledger clock stamp


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(j_smoke("smollm_360m"), w_bits=2)
    tc = dataclasses.replace(t_smoke("smollm_360m"), w_bits=2)
    jp = jlm.init_params(jc, jax.random.key(3))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _counter_clock():
    """A deterministic clock: every reading is one tick (1 ms) later."""
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _observed_run(sched_cls, pool, cfg, params, mods, residency=None):
    tracker_mod, spans_mod, mem_mod = mods
    tr = tracker_mod.MemoryTracker()
    clock = _counter_clock()
    spans = spans_mod.SpanRecorder(clock, tracker=tr)
    ledger = mem_mod.MemLedger(clock, tracker=tr)
    monitor = mem_mod.MemPressureMonitor()
    sched = sched_cls(
        cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
        residency=residency, tracker=tr, spans=spans, ledger=ledger,
        mem_monitor=monitor,
    )
    rng = np.random.default_rng(42)
    for p, gen in zip(PROMPT_LENS, GEN):
        sched.submit(rng.integers(0, cfg.vocab, size=p).astype(np.int32), gen)
    stats = sched.run()
    return sched, stats, tr, spans, monitor


def _drop(recs, keys):
    return [{k: v for k, v in r.items() if k not in keys} for r in recs]


@pytest.fixture(scope="module", params=["unbudgeted", "budgeted"])
def runs(request, weights):
    jc, tc, jp, tp = weights
    jres = tres = None
    if request.param == "budgeted":
        total = sum(b.padded_bytes() for b in tplan.weight_blocks(tc))
        jres = jplan.compile_residency_plan(jc, vmem_budget_bytes=total // 2)
        tres = tplan.compile_residency_plan(tc, vmem_budget_bytes=total // 2)
        assert any(tres.layer_stream_mask(tc))
    j = _observed_run(
        JSched, JPool.for_slots(jc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK),
        jc, jp, (j_tracker, j_spans, j_mem), jres,
    )
    t = _observed_run(
        TSched,
        TPool.for_slots(tc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK, device="cpu"),
        tc, tp, (t_tracker, t_spans, t_mem), tres,
    )
    return j, t


def test_round_records_match_reference(runs):
    (js, _, jtr, _, _), (ts, _, ttr, _, _) = runs
    assert ts.outputs() == js.outputs()
    assert len(ttr.records) == len(jtr.records) > 5
    for got, want in zip(ttr.records, jtr.records):
        # TTFTs are host-clock readings: the same count, other values
        assert len(got["ttfts"]) == len(want["ttfts"])
        assert _drop([got], ("ttfts",)) == _drop([want], ("ttfts",))
    assert any(r["chunked_prefills"] for r in ttr.records)
    h_got, h_want = dict(ttr.hparams[0]), dict(jtr.hparams[0])
    assert h_got.pop("compiled") is False
    # the port's residency summary labels its figures as plan arithmetic
    # (tests/test_torch_residency.py holds it against the reference's)
    assert (h_got.pop("residency", None) is None) == (h_want.pop("residency", None) is None)
    assert h_got == h_want


def test_span_records_match_reference_and_tile(runs):
    (_, _, jtr, _, _), (ts, _, ttr, tspans, _) = runs
    assert _drop(ttr.spans, STAMPS) == _drop(jtr.spans, STAMPS)
    phases = {s["phase"] for s in ttr.spans}
    assert phases == {"queue", "prefill", "decode", "wait"}
    # every request's spans tile [submit, done]: contiguous, from its queue
    # span's start to its done stamp, with admit/first on boundaries
    events = tspans.drain_events()
    assert sorted(k for k, _, _ in events) == sorted(
        ["admit", "first", "done"] * len(PROMPT_LENS)
    )
    stream = ttr.stream + [{"kind": "metrics", "events": events}]
    assert t_spans.validate_trace(stream) == []
    by_rid = t_spans.request_spans(stream)
    done = {rid: t for kind, rid, t in events if kind == "done"}
    for rid, ss in by_rid.items():
        assert ss[0]["phase"] == "queue" and ss[-1]["t1"] == done[rid]
        assert all(a["t1"] == b["t0"] for a, b in zip(ss, ss[1:]))
    dec = t_spans.decompose(stream)
    assert set(dec) == set(range(len(PROMPT_LENS)))
    assert all(d["queue"] >= 0 and d["prefill"] > 0 for d in dec.values())
    # a tiling fault is caught: shift one span
    broken = [dict(s) for s in stream]
    next(s for s in broken if s.get("phase") == "decode")["t0"] += 1e-3
    assert t_spans.validate_trace(broken)


def test_ledger_records_match_reference_and_integrate(runs):
    (_, _, jtr, _, jmon), (_, _, ttr, _, tmon) = runs
    assert _drop(ttr.mems, WALL) == _drop(jtr.mems, WALL)
    ops = {m["op"] for m in ttr.mems}
    assert {"attach", "admit", "grow", "release"} <= ops
    assert t_mem.validate_ledger(ttr.stream) == []
    assert t_mem.validate_ledger(ttr.stream) == j_mem.validate_ledger(ttr.stream)
    assert _drop(t_mem.summarize_ledger(ttr.stream)["engines"], ("peak_t",)) == _drop(
        j_mem.summarize_ledger(jtr.stream)["engines"], ("peak_t",))
    # a gauge that does not integrate is caught
    broken = [dict(r) for r in ttr.stream]
    rec = next(r for r in broken if r.get("kind") == "metrics" and r["pool_held_blocks"])
    rec["pool_held_blocks"] += 1
    assert t_mem.validate_ledger(broken)
    # the pressure monitor's summaries agree but for the clock stamp of the peak
    assert _drop([tmon.summary(now=1.0)], ("peak_t",)) == _drop(
        [jmon.summary(now=1.0)], ("peak_t",))


def test_replay_summary_equals_live_counters(runs):
    _, (ts, stats, ttr, _, _) = runs
    got = t_tracker.replay_summary(ttr.stream)
    for k in t_tracker.DELTA_KEYS:
        assert got[k] == getattr(stats, k), k
    assert got["rounds"] == stats.rounds
    assert got["ttfts"] == pytest.approx(stats.ttfts, abs=1e-6)
    assert got["decode_steps"] > 0 and got["completed"] == len(PROMPT_LENS)
    assert got["pool_utilization"] == round(ts.pool.stats().utilization, 4)


def test_trace_export_matches_reference(runs):
    (_, _, jtr, _, _), (_, _, ttr, _, _) = runs
    doc = t_export.to_trace_events(ttr.stream)
    assert t_export.validate_trace_events(doc) == []
    assert j_export.validate_trace_events(doc) == []
    assert doc == t_export.to_trace_events(json.loads(json.dumps(ttr.stream)))
    want = j_export.to_trace_events(jtr.stream)
    kinds = lambda d: sorted((e["ph"], e["name"]) for e in d["traceEvents"])  # noqa: E731
    assert kinds(doc) == kinds(want)
    assert any(e["ph"] == "C" for e in doc["traceEvents"])
    bad = {"traceEvents": [{"ph": "X", "name": "x", "ts": 0.0, "dur": -1.0}]}
    assert t_export.validate_trace_events(bad)


def test_stats_cover_the_replay_contract():
    assert t_tracker.delta_coverage_gaps() == []
    assert t_tracker.delta_coverage_gaps(TStats) == []
    assert t_tracker.DELTA_KEYS == j_tracker.DELTA_KEYS
    assert t_tracker.NON_DELTA_STATS_FIELDS == j_tracker.NON_DELTA_STATS_FIELDS
    names = {f.name for f in dataclasses.fields(TStats)}
    assert set(t_tracker.DELTA_KEYS) <= names

    @dataclasses.dataclass
    class Grown(TStats):
        new_counter: int = 0

    assert t_tracker.delta_coverage_gaps(Grown) == ["new_counter"]


def test_pool_reports_match_reference():
    jc, tc = j_smoke("smollm_360m"), t_smoke("smollm_360m")
    jp = JPool.for_slots(jc, slots=3, max_len=23, block_tokens=4)
    tp = TPool.for_slots(tc, slots=3, max_len=23, block_tokens=4, device="cpu")
    steps = [("admit", 0, 23), ("note", 0, 9), ("admit", 1, 10), ("note", 1, 3),
             ("admit", 2, 17), ("note", 2, 17), ("note", 0, 14), ("release", 1, 0),
             ("note", 2, 17), ("admit", 3, 6), ("note", 3, 5)]
    for op, rid, n in steps:
        for pool in (jp, tp):
            {"admit": lambda: pool.admit(rid, n), "note": lambda: pool.note_tokens(rid, n),
             "release": lambda: pool.release(rid)}[op]()
        assert tp.fragmentation_report() == jp.fragmentation_report()
        ts, js = tp.stats(), jp.stats()
        assert ts.occupancy == js.occupancy
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert tp.live_requests() == jp.live_requests()
        for r in tp.live_requests():
            assert tp.tokens_held(r) == jp.tokens_held(r)
        assert (tp.alloc_blocks, tp.freed_blocks, tp.cow_copies) == (
            jp.alloc_blocks, jp.freed_blocks, jp.cow_copies)
    tp.validate()
    assert t_mem.kv_block_bytes(tp) == j_mem.kv_block_bytes(jp)


def test_pool_ledger_hooks_match_reference():
    """The same pool operations under a ledger: the same records."""
    jc, tc = j_smoke("smollm_360m"), t_smoke("smollm_360m")
    out = []
    for pool, mem, tracker in (
        (JPool.for_slots(jc, slots=2, max_len=12, block_tokens=4), j_mem, j_tracker),
        (TPool.for_slots(tc, slots=2, max_len=12, block_tokens=4, device="cpu"),
         t_mem, t_tracker),
    ):
        tr = tracker.MemoryTracker()
        ledger = mem.MemLedger(_counter_clock(), tracker=tr)
        ledger.attach(pool)
        assert pool.ledger is ledger
        pool.admit(7, 12)
        pool.note_tokens(7, 3)
        pool.note_tokens(7, 5)
        ledger.sync()
        pool.release(7)
        ledger.reserve("ring-slot", 4096, depth=4)
        ledger.flush()
        out.append(tr.mems)
    assert out[1] == out[0]
    assert [m["op"] for m in out[1]] == ["attach", "admit", "grow", "grow", "sync",
                                         "release", "reserve"]


@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_residency_records_match_reference_at_full_size(w_bits):
    jc = dataclasses.replace(j_full("smollm_360m"), w_bits=w_bits)
    tc = dataclasses.replace(t_full("smollm_360m"), w_bits=w_bits)
    for kw in ({}, dict(lanes=2, prompt_len=4, gen_len=4), dict(lanes=8, prompt_len=512,
                                                                  gen_len=64)):
        jt, tt = jplan.TrafficProfile(**kw), tplan.TrafficProfile(**kw)
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        assert tt.mean_context == jt.mean_context
        assert tplan.fixed_hbm_bytes(tc, tt) == jplan.fixed_hbm_bytes(jc, jt)
    total = sum(b.padded_bytes() for b in tplan.weight_blocks(tc))
    for frac in (0.0, 0.25, 0.5, 1.0):
        budget = int(total * frac)
        want = jplan.compile_residency_plan(jc, vmem_budget_bytes=budget)
        got = tplan.compile_residency_plan(tc, vmem_budget_bytes=budget)
        assert got.ring_bytes == want.ring_bytes
        assert got.hbm_traffic_reduction == want.hbm_traffic_reduction
        assert got.resident_bytes == want.resident_bytes
    assert tplan.compile_residency_plan(tc, vmem_budget_bytes=0).ring_bytes > 0


def test_streaming_monitors_match_reference():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(mean=-3, sigma=1.5, size=500)

    @dataclasses.dataclass(frozen=True)
    class Slo:
        ttft: float = 0.2
        tpot: float = 0.05
        target: float = 0.9

    mons = [m.SLOMonitor(Slo(), windows=(1.0, 10.0)) for m in (j_spans, t_spans)]
    hists = [m.StreamingHist() for m in (j_spans, t_spans)]
    for i, v in enumerate(vals):
        for mon, h in zip(mons, hists):
            h.add(float(v))
            mon.observe(t=i * 0.05, ttft=float(v), tpot=float(v) / 4, queue_wait=float(v) / 2)
    assert hists[1].summary() == hists[0].summary()
    assert mons[1].summary(now=25.0) == mons[0].summary(now=25.0)
    clocks = [m.VirtualClock(1.5) for m in (j_spans, t_spans)]
    for c in clocks:
        c.advance(0.25)
    assert clocks[1].now() == clocks[0].now() == 1.75


def test_jsonl_and_composite_trackers_round_trip(tmp_path):
    path = tmp_path / "trace.jsonl"
    mem = t_tracker.MemoryTracker()
    tr = t_tracker.CompositeTracker(t_tracker.JsonlTracker(path), mem,
                                    t_tracker.NullTracker())
    tr.log_hyperparameters({"arch": "x", "lanes": np.int64(3)})
    tr.log_metrics({"decode_steps": np.int32(2), "ttfts": (0.5,)}, step=1)
    tr.log_spans([{"rid": 0, "phase": "queue", "t0": 0.0, "t1": 1.0}])
    tr.log_mem([{"op": "sync", "owner": "pool", "t": 1.0}])
    tr.finish()
    got = t_tracker.read_jsonl(path)
    assert [r["kind"] for r in got] == ["hparams", "metrics", "span", "mem"]
    assert got[0]["lanes"] == 3 and got[1]["ttfts"] == [0.5]
    assert [r["kind"] for r in mem.stream] == [r["kind"] for r in got]
    assert t_tracker.replay_summary(got)["decode_steps"] == 2


def test_untraced_monitor_windows_see_the_run(weights):
    """Without spans the pressure monitor is fed on the host's monotonic
    clock, the one ``mem_summary`` reads, so every round lies in its
    windows: with a ceiling no round meets, each window burns."""
    _, tc, _, tp = weights
    pool = TPool.for_slots(tc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK, device="cpu")
    monitor = t_mem.MemPressureMonitor(t_mem.MemPolicy(max_occupancy=-1.0))
    sched = TSched(tc, tp, pool, slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                   mem_monitor=monitor)
    rng = np.random.default_rng(42)
    for p, gen in zip(PROMPT_LENS, GEN):
        sched.submit(rng.integers(0, tc.vocab, size=p).astype(np.int32), gen)
    stats = sched.run()
    summary = sched.mem_summary()
    assert summary["observed"] == summary["violations"] == stats.rounds > 0
    budget = 1.0 - monitor.policy.target
    assert summary["burn_rates"] == {
        f"{int(w)}s": pytest.approx(1.0 / budget) for w in monitor.windows
    }
    assert summary["signal"] == "pressure"


@pytest.mark.parametrize("spans", [True, False], ids=["spans", "no_spans"])
def test_serve_cli_trace_out_exports(tmp_path, capsys, spans):
    trace = tmp_path / "serve.jsonl"
    argv = ["--smoke", "--device", "cpu", "--quant", "2", "--requests", "4",
            "--prompt-len", "12", "--prefill-chunk", "8", "--trace-out", str(trace)]
    if not spans:
        argv.append("--no-trace-spans")
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve/mem] signal ok" in out
    m = json.loads(next(l for l in out.splitlines() if l.startswith("[serve/metrics] "))
                   .split(" ", 1)[1])
    assert m["compiled"] is False and len(m["outputs"]) == 4
    records = t_tracker.read_jsonl(trace)
    kinds = {r["kind"] for r in records}
    assert kinds == ({"hparams", "metrics", "mem"} | ({"span"} if spans else set()))
    assert (m["span_records"] > 0) == spans
    assert m["mem_records"] == sum(r["kind"] == "mem" for r in records)
    assert t_mem.validate_ledger(records) == []
    assert t_spans.validate_trace(records) == []
    summary = t_tracker.replay_summary(records)
    assert summary["completed"] == 4 and summary["generated_tokens"] == m["generated_tokens"]
    assert summary["decode_steps"] == m["decode_steps"]
    doc_path = tmp_path / "serve.perfetto.json"
    assert t_export.main([str(trace), "--check", "-o", str(doc_path)]) == 0
    assert "trace_event shape: OK" in capsys.readouterr().out
    doc = json.loads(doc_path.read_text())
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == m["span_records"]
