"""Port parity for fleet serving (``runtime.cluster`` and ``launch.fleet``):
the port's traffic generator, GALS provisioning, cost model, router,
fleet and disaggregated clusters against the reference's on the same
weights (smoke configs in float32, carried across with ``interop``) and
the same cost-model floats. Token streams are held exactly; every
request's virtual timings (arrival, admit, first, done) and the SLO
report's row within 1e-9. The scheduler's handoff hooks (prefill on A,
decode on B) are held under a hypothesis-swept seed, greedy and seeded;
the hybrid payload carries a device copy of its lane state; drain,
chunked admission, prefix-aware and affinity routing, impossible
requests; the fleet's spans, memory ledger and tracker stream; and the
CLI on the CPU in its three modes."""

import dataclasses
import functools
import json
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.perf.roofline import HW as J_HW  # noqa: E402
from repro.runtime import cluster as j_cluster  # noqa: E402
from repro.runtime import memledger as j_mem  # noqa: E402
from repro.runtime import speculative as j_spec  # noqa: E402
from repro.runtime import spans as j_spans  # noqa: E402
from repro.runtime import tracker as j_tracker  # noqa: E402
from repro.runtime.cluster import traffic as j_traffic  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.scheduler import RequestState as JState  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.resource_model import H100_SXM  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import fleet  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.perf import roofline as t_roofline  # noqa: E402
from repro_torch.runtime import cluster as t_cluster  # noqa: E402
from repro_torch.runtime import memledger as t_mem  # noqa: E402
from repro_torch.runtime import speculative as t_spec  # noqa: E402
from repro_torch.runtime import spans as t_spans  # noqa: E402
from repro_torch.runtime import tracker as t_tracker  # noqa: E402
from repro_torch.runtime.cluster import traffic as t_traffic  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.scheduler import RequestState as TState  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402

SLOTS, MAX_LEN, BLOCK = 2, 48, 4
TIME_TOL = 1e-9
REF = types.SimpleNamespace(
    name="ref", configs=j_configs, lm=jlm, cluster=j_cluster, traffic=j_traffic,
    Pool=JPool, Sched=JSched, State=JState, spans=j_spans, mem=j_mem, tracker=j_tracker,
    spec=j_spec, pool_kw={},
)
PORT = types.SimpleNamespace(
    name="port", configs=t_configs, lm=tlm, cluster=t_cluster, traffic=t_traffic,
    Pool=TPool, Sched=TSched, State=TState, spans=t_spans, mem=t_mem, tracker=t_tracker,
    spec=t_spec, pool_kw={"device": "cpu"},
)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _weights(arch: str, w_bits: int = 0):
    """{side: (smoke cfg, params)}: the reference's draw, and the port's
    copy of it."""
    jc = dataclasses.replace(j_configs.get_smoke_config(arch), w_bits=w_bits)
    tc = dataclasses.replace(t_configs.get_smoke_config(arch), w_bits=w_bits)
    jp = jlm.init_params(jc, jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return {"ref": (jc, jp), "port": (tc, tp)}


@functools.lru_cache(maxsize=None)
def _costs(arch: str, w_bits: int = 0):
    """{side: StepCostModel}: the reference's floats (its full-size config
    on its hardware record), and the port's model built from them."""
    j = j_cluster.StepCostModel.for_config(
        dataclasses.replace(j_configs.get_config(arch), w_bits=w_bits), slots=SLOTS)
    return {"ref": j, "port": t_cluster.StepCostModel(**dataclasses.asdict(j))}


def _spec(side, vocab, **kw):
    kw.setdefault("n_requests", 10)
    kw.setdefault("arrival_rate", 2000.0)
    kw.setdefault("prompt_lens", ((6, 0.5), (10, 0.5)))
    kw.setdefault("gen_lens", ((4, 0.5), (8, 0.5)))
    kw.setdefault("seed", 2)
    return side.cluster.TrafficSpec(vocab=vocab, **kw)


def _cluster(side, kind, arch="smollm_360m", w_bits=0, spec=None, **kw):
    cfg, params = _weights(arch, w_bits)[side.name]
    common = dict(slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK,
                  cost=_costs(arch, w_bits)[side.name])
    common.update(kw)
    if kind == "disagg":
        return side.cluster.DisaggCluster(cfg, params, spec=spec, **common)
    return side.cluster.FleetCluster(cfg, params, **common)


def _trace(side, arch="smollm_360m", **kw):
    cfg = _weights(arch)[side.name][0]
    spec = _spec(side, cfg.vocab, **kw)
    return spec, side.cluster.synthesize(spec)


def _run_both(kind, arch="smollm_360m", w_bits=0, trace_kw=None, run_kw=None, **kw):
    """The same cluster on both sides over the same trace: {side: (cluster,
    result)}."""
    out = {}
    for side in SIDES:
        spec, trace = _trace(side, arch, **(trace_kw or {}))
        cl = _cluster(side, kind, arch, w_bits, spec=spec, **kw)
        out[side.name] = (cl, cl.run(trace, **(run_kw or {})))
    return out


def _same_time(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TIME_TOL


def _assert_timings_match(j_res, t_res):
    assert j_res.timings.keys() == t_res.timings.keys()
    for rid, jt in j_res.timings.items():
        tt = t_res.timings[rid]
        for name in ("t_arrival", "t_admit", "t_first", "t_done"):
            assert _same_time(getattr(jt, name), getattr(tt, name)), (rid, name)
        assert jt.n_tokens == tt.n_tokens


def _assert_rows_match(j_row: dict, t_row: dict):
    assert j_row.keys() == t_row.keys()
    for key, jv in j_row.items():
        if isinstance(jv, float):
            assert abs(jv - t_row[key]) <= TIME_TOL * max(1.0, abs(jv)), key
        else:
            assert jv == t_row[key], key


SUMMARY_COUNTERS = ("completed", "handoffs", "prefill_steps", "prefill_tokens", "decode_steps",
                    "generated_tokens", "prefix_hits", "prefix_hit_tokens", "expert_tokens",
                    "accepted_tokens", "draft_tokens", "verify_steps")


def _assert_parity(runs, slo=(1.0, 1.0)):
    (jc, j_res), (tc, t_res) = runs["ref"], runs["port"]
    assert t_res.outputs == j_res.outputs
    _assert_timings_match(j_res, t_res)
    j_row = j_res.report(j_cluster.SloPolicy(*slo)).row()
    t_row = t_res.report(t_cluster.SloPolicy(*slo)).row()
    _assert_rows_match(j_row, t_row)
    assert t_res.assignments == j_res.assignments
    for js, ts in zip(j_res.engine_summaries, t_res.engine_summaries):
        for key in SUMMARY_COUNTERS:
            assert ts[key] == js[key], key
        assert abs(ts["clock_s"] - js["clock_s"]) <= 1e-6


# ---------------- traffic, provisioning, cost model ----------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_requests=32, prompt_lens=((128, 0.5), (512, 0.35), (1024, 0.15)),
         gen_lens=((64, 0.7), (128, 0.3)), session_reuse=0.3, vocab=49152, seed=1),
    dict(n_requests=20, arrival_rate=20.0, session_reuse=0.6, seed=5),
], ids=["default", "chip_trace", "sessions"])
def test_synthesize_matches_reference(kw):
    j, t = j_cluster.TrafficSpec(**kw), t_cluster.TrafficSpec(**kw)
    assert (t.mean_prompt_len, t.mean_gen_len, t.max_total_tokens) == (
        j.mean_prompt_len, j.mean_gen_len, j.max_total_tokens)
    ja, ta = j_cluster.synthesize(j), t_cluster.synthesize(t)
    assert len(ta) == len(ja) == j.n_requests
    for x, y in zip(ja, ta):
        assert (y.rid, y.t_arrival, y.max_new_tokens, y.session, y.total_tokens) == (
            x.rid, x.t_arrival, x.max_new_tokens, x.session, x.total_tokens)
        assert y.prompt.dtype == x.prompt.dtype and np.array_equal(y.prompt, x.prompt)
    assert [r.t_arrival for r in t_cluster.synthesize(dataclasses.replace(t, seed=t.seed + 1))
            ] != [r.t_arrival for r in ta]


def test_provision_split_matches_reference():
    rates = [(300.0, 100.0), (100.0, 100.0), (100.0, 300.0), (2610.3, 1036.5), (1e4, 7.0),
             (7.0, 1e4), (150.0, 100.0)]
    for n in range(2, 9):
        for p, d in rates:
            jr = j_cluster.RoleRates(prefill_req_rate=p, decode_req_rate=d)
            tr = t_cluster.RoleRates(prefill_req_rate=p, decode_req_rate=d)
            assert tr.r_f == jr.r_f
            for ports in (1, 2):
                assert t_cluster.provision_split(n, tr, ports) == j_cluster.provision_split(
                    n, jr, ports), (n, p, d, ports)
    # the reference's own cases: a fast prefill tier concentrates engines
    # on decode, and vice versa
    mk = t_cluster.RoleRates
    assert t_cluster.provision_split(4, mk(300.0, 100.0)) == (1, 3)
    assert t_cluster.provision_split(4, mk(100.0, 100.0)) == (2, 2)
    assert t_cluster.provision_split(4, mk(100.0, 300.0)) == (3, 1)
    with pytest.raises(ValueError):
        t_cluster.provision_split(1, mk(100.0, 100.0))


@pytest.mark.parametrize("arch", ["smollm_360m", "olmoe_1b_7b", "zamba2_2p7b", "whisper_tiny",
                                  "internvl2_76b", "mamba2_1p3b", "phi3_medium_14b"])
def test_cost_model_and_param_counts_match_reference(arch):
    """``StepCostModel.for_config`` on a ``HwModel`` built from the
    reference's ``HW`` gives the reference's fields (w_bits 0, 1, 2), and
    the configs count the reference's parameters; the modelled role rates
    and split follow."""
    hw = t_roofline.HwModel(**dataclasses.asdict(J_HW))
    jfull, tfull = j_configs.get_config(arch), t_configs.get_config(arch)
    assert (tfull.n_params(), tfull.active_params()) == (jfull.n_params(), jfull.active_params())
    for w_bits in (0, 1, 2):
        jc, tc = (dataclasses.replace(c, w_bits=w_bits) for c in (jfull, tfull))
        for slots in (2, 8):
            j = j_cluster.StepCostModel.for_config(jc, slots=slots)
            t = t_cluster.StepCostModel.for_config(tc, slots=slots, hw=hw)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            spec_kw = dict(vocab=tfull.vocab, seed=1)
            jr = j_cluster.measured_role_rates(j, j_cluster.TrafficSpec(**spec_kw), slots=slots)
            tr = t_cluster.measured_role_rates(t, t_cluster.TrafficSpec(**spec_kw), slots=slots)
            assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
            assert t_cluster.provision_split(4, tr) == j_cluster.provision_split(4, jr)


def test_hw_record_is_the_h100():
    """The port's ``HW`` is the H100 SXM: ``core.resource_model``'s HBM
    rate and bf16 peak, NVLink 4 one way; at 2 bits smollm-360m's modelled
    decode step is its weight bytes over the HBM rate (~0.093 ms), and
    packing shrinks it."""
    hw = t_roofline.HW
    assert (hw.hbm_bw, hw.peak_flops, hw.ici_bw) == (H100_SXM.hbm_bw, H100_SXM.peak_bf16_flops,
                                                    450e9)
    full = t_configs.get_config("smollm_360m")
    dense = t_cluster.StepCostModel.for_config(full, slots=8)
    packed = t_cluster.StepCostModel.for_config(dataclasses.replace(full, w_bits=2), slots=8)
    ffn = 3 * full.d_model * full.d_ff * full.n_layers * 2
    want = (full.active_params() * 2 - ffn + ffn * 2 // 16) / H100_SXM.hbm_bw
    assert packed.decode_s_per_step == pytest.approx(want, rel=1e-12)
    assert 0.09e-3 < packed.decode_s_per_step < 0.095e-3 < dense.decode_s_per_step
    # 40,960 B of K/V a token over 450 GB/s
    assert packed.handoff_s_per_token == pytest.approx(40960 / 450e9, rel=1e-12)


def test_resolve_carries_the_full_size_drafter():
    """``draft_full_cfg``: the full-size drafter at ``--spec-quant`` bits,
    the reference's, served at the smoke size or at full size."""
    for smoke in (True, False):
        get = "get_smoke_config" if smoke else "get_config"
        t = t_spec.resolve(getattr(t_configs, get)("smollm_360m"),
                           t_spec.SpecConfig(drafter="smollm_360m", depth=4, quant=2),
                           smoke=smoke)
        j = j_spec.resolve(getattr(j_configs, get)("smollm_360m"),
                           j_spec.SpecConfig(drafter="smollm_360m", depth=4, quant=2),
                           smoke=smoke)
        assert t.draft_full_cfg.w_bits == 2 and t.draft_full_cfg.n_layers == 32
        assert (t.draft_full_cfg.n_params(), t.draft_cfg.name, t.draft_cfg.w_bits) == (
            j.draft_full_cfg.n_params(), j.draft_cfg.name, j.draft_cfg.w_bits)
    cfg = t_configs.get_smoke_config("smollm_360m")
    assert t_spec.resolve(cfg, t_spec.SpecConfig(drafter="ngram")).draft_full_cfg is None


# ---------------- the handoff (scheduler level) ----------------


def _sched(side, arch="smollm_360m", **kw):
    cfg, params = _weights(arch)[side.name]
    pool = side.Pool.for_slots(cfg, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK,
                               **side.pool_kw)
    return side.Sched(cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, **kw)


def _busy(sched):
    return sched.queue or any(r is not None for r in sched.active)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_handoff_reproduces_single_engine_stream(seed):
    """A request prefilled on scheduler A (its handoff hook) and decoded on
    B gives the single-engine stream, greedy and seeded, and the
    reference's; A keeps no block, and the payload's rows are copies."""
    cfg = _weights("smollm_360m")["port"][0]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=(int(rng.integers(3, 9)),)).astype(np.int32)
               for _ in range(3)]
    gen = int(rng.integers(2, 6))
    for sampling in (None, dict(temperature=0.8, top_k=16, top_p=0.9, seed=seed)):
        outs = {}
        for side in SIDES:
            kw = {"sampling": side.lm.SamplingParams(**sampling)} if sampling else {}
            single = _sched(side, **kw)
            for i, p in enumerate(prompts):
                single.submit(p, gen, rid=i)
            single.run()
            outs[side.name] = single.outputs()
        kw = {"sampling": tlm.SamplingParams(**sampling)} if sampling else {}
        payloads = []
        a = _sched(PORT, handoff=payloads.append, **kw)
        b = _sched(PORT, **kw)
        for i, p in enumerate(prompts):
            a.submit(p, gen, rid=i)
        while _busy(a):
            a.round()
        assert a.stats.handoffs == len(prompts) and a.stats.decode_steps == 0
        assert all(r.state is TState.HANDOFF for r in a.requests.values())
        a.pool.validate()
        assert a.pool.free_blocks + a.pool.cached_blocks == a.pool.usable_blocks
        for pl in payloads:
            assert len(pl.block_ids) * pl.block_tokens >= pl.n_tokens
            assert pl.k.shape == (cfg.n_layers, pl.n_tokens, cfg.n_kv, cfg.hd)
            assert pl.k.untyped_storage().data_ptr() != a.pool.k.untyped_storage().data_ptr()
            assert pl.kv_bytes == pl.k.nbytes + pl.v.nbytes
            while not b.import_prefilled(pl):
                b.round()
        while _busy(b):
            b.round()
        b.pool.validate()
        assert b.outputs() == outs["port"] == outs["ref"]


def test_hybrid_handoff_payload_carries_lane_state():
    """The hybrid payload carries a device copy of the lane state (not
    the lane itself) equal to the reference's snapshot; importing without
    it is an error, not silent drift."""
    payloads = {}
    for side in SIDES:
        got = []
        a = _sched(side, "zamba2_2p7b", handoff=got.append)
        a.submit(np.arange(5, dtype=np.int32) % 512, 3)
        while _busy(a):
            a.round()
        payloads[side.name] = (a, got[0])
    a, pl = payloads["port"]
    _, jpl = payloads["ref"]
    assert pl.lane_state is not None and pl.kv_bytes > pl.k.nbytes + pl.v.nbytes
    for key, leaf in pl.lane_state.items():
        assert leaf.device == a.pool.device and leaf.shape[1] == 1
        assert leaf.untyped_storage().data_ptr() != a._lane_state[key].untyped_storage().data_ptr()
        np.testing.assert_allclose(leaf.float().numpy(), np.asarray(jpl.lane_state[key], np.float32),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pl.k.numpy(), np.asarray(jpl.k), rtol=1e-4, atol=1e-5)
    b = _sched(PORT, "zamba2_2p7b")
    with pytest.raises(ValueError, match="lane state"):
        b.import_prefilled(dataclasses.replace(pl, lane_state=None))
    assert b.import_prefilled(pl)


# ---------------- clusters against the reference ----------------


@pytest.mark.parametrize("w_bits", [0, 1])
def test_single_fleet_and_disagg_match_reference(w_bits):
    """single (1 engine), fleet (2) and disagg (3, provisioned) on both
    sides with the reference's cost floats: identical streams across modes
    and sides, every request's virtual timings and the SLO row within
    1e-9; two engines finish sooner than one."""
    runs = {mode: _run_both(kind, w_bits=w_bits, n_engines=n)
            for mode, kind, n in (("single", "fleet", 1), ("fleet", "fleet", 2),
                                  ("disagg", "disagg", 3))}
    single = runs["single"]["port"][1]
    _, trace = _trace(PORT)
    assert all(len(single.outputs[r.rid]) == r.max_new_tokens for r in trace)
    for mode, r in runs.items():
        _assert_parity(r)
        assert r["port"][1].outputs == single.outputs, mode
        for e in r["port"][0].engines:
            e.scheduler.pool.validate()
    disagg_cl = runs["disagg"]["port"][0]
    assert disagg_cl.split == runs["disagg"]["ref"][0].split
    assert sum(s["handoffs"] for s in runs["disagg"]["port"][1].engine_summaries) == 10
    mk = lambda res: max(t.t_done for t in res.timings.values())  # noqa: E731
    assert mk(runs["fleet"]["port"][1]) < mk(single)
    rep = runs["fleet"]["port"][1].report(t_cluster.SloPolicy(ttft=1.0, tpot=1.0))
    assert rep.completed == rep.slo_met == 10


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "olmoe_1b_7b"])
def test_hybrid_and_moe_disagg_match_single_and_reference(arch):
    """A hybrid payload carries its lane state, a MoE one only its K/V
    rows: prefill-on-A / decode-on-B gives single-engine serving's
    streams, the reference's, at the reference's virtual timings."""
    single = _run_both("fleet", arch, n_engines=1, trace_kw=dict(n_requests=6))
    disagg = _run_both("disagg", arch, n_engines=2, trace_kw=dict(n_requests=6))
    _assert_parity(single)
    _assert_parity(disagg)
    assert disagg["port"][1].outputs == single["port"][1].outputs
    summaries = disagg["port"][1].engine_summaries
    assert sum(s["handoffs"] for s in summaries) == 6
    if arch == "olmoe_1b_7b":
        assert all(s["expert_tokens"] > 0 for s in summaries)


@pytest.mark.parametrize("drafter", ["ngram", "smollm_360m"])
def test_speculating_fleet_matches_reference(drafter):
    """Each engine drafts its own lanes; the verify and (for the twin) the
    draft charges land where the reference's do, so the timings agree (the
    twin's draft cost, which an engine derives from the full-size drafter
    on its hardware record, is given the reference's floats)."""
    runs = {}
    for side in SIDES:
        cfg = _weights("smollm_360m")[side.name][0]
        resolved = side.spec.resolve(cfg, side.spec.SpecConfig(drafter=drafter, depth=3, quant=2),
                                     smoke=True)
        spec, trace = _trace(side, n_requests=6)
        cl = _cluster(side, "fleet", n_engines=2, speculative=resolved)
        if side is PORT:
            for e, je in zip(cl.engines, runs["ref"][0].engines):
                assert (e.draft_cost is None) == (je.draft_cost is None)
                if je.draft_cost is not None:
                    e.draft_cost = t_cluster.StepCostModel(**dataclasses.asdict(je.draft_cost))
        runs[side.name] = (cl, cl.run(trace))
    _assert_parity(runs)
    plain = _run_both("fleet", n_engines=2, trace_kw=dict(n_requests=6))
    assert runs["port"][1].outputs == plain["port"][1].outputs
    assert sum(s["verify_steps"] for s in runs["port"][1].engine_summaries) > 0


def test_disagg_one_token_requests_complete():
    """A request whose one token arrives with the handoff finishes at its
    import and is timed as completed."""
    runs = _run_both("disagg", n_engines=2, trace_kw=dict(n_requests=4, gen_lens=((1, 1.0),)))
    _assert_parity(runs)
    res = runs["port"][1]
    rep = res.report(t_cluster.SloPolicy(ttft=1.0, tpot=1.0))
    assert rep.completed == 4 and rep.goodput_tokens_per_s > 0
    assert all(not math.isnan(t.t_done) for t in res.timings.values())


def test_router_chunked_admission_takes_over_budget_prompt():
    """A prompt over every engine's token budget lands on an idle engine
    and streams through budget-sized chunks, with an unbudgeted engine's
    stream."""
    outs = {}
    for side in SIDES:
        cfg = _weights("smollm_360m")[side.name][0]
        long_p = np.random.default_rng(41).integers(0, cfg.vocab, size=(20,)).astype(np.int32)
        trace = [side.traffic.ClientRequest(0, 0.0, long_p, 4, 0)]
        big = _cluster(side, "fleet", n_engines=1).run(trace)
        budgeted = _cluster(side, "fleet", n_engines=2, token_budget=16)
        assert all(e.scheduler.token_budget < 24 for e in budgeted.engines)
        res = budgeted.run(trace)
        assert res.outputs == big.outputs
        assert sum(s["prefill_steps"] for s in res.engine_summaries) == 2
        outs[side.name] = res.outputs
    assert outs["port"] == outs["ref"]


def test_drain_loses_and_duplicates_nothing():
    """Draining an engine mid-run requeues its queued requests onto the
    survivor; every request completes once, with its single-engine stream,
    at the reference's timings and placements."""
    runs = _run_both("fleet", n_engines=2, token_budget=2 * 18,
                     trace_kw=dict(n_requests=12), run_kw=dict(drain_at=(0, 0.004)))
    _assert_parity(runs)
    cl, res = runs["port"]
    assert cl.engines[0].drained
    moved = [rid for rid, eids in cl.router.assignments.items() if len(eids) > 1]
    assert moved, "the drain moved nothing (the test is inert)"
    assert all(eids[-1] == 1 for eids in cl.router.assignments.values() if len(eids) > 1)
    single = _run_both("fleet", n_engines=1, trace_kw=dict(n_requests=12))["port"][1]
    assert res.outputs == single.outputs
    assert sorted(res.outputs) == list(range(12))


def test_scheduler_drain_releases_a_live_chunk():
    """A drain gives back a mid-chunk request with its blocks, cursor and
    lane released, and the queue behind it."""
    sched = _sched(PORT, token_budget=8)
    rng = np.random.default_rng(4)
    sched.submit(rng.integers(0, 512, size=(24,)).astype(np.int32), 4)
    sched.submit(rng.integers(0, 512, size=(5,)).astype(np.int32), 2)
    sched._admit_one()  # the first chunk in, the request mid-flight
    assert sched._chunk_cursor and sched.pool.live_requests() == [0]
    moved = sched.drain()
    assert [r.rid for r in moved] == [0, 1]
    assert all(r.state is TState.QUEUED and not r.output for r in moved)
    assert not sched._chunk_cursor and sched.active == [None] * SLOTS and not sched.requests
    sched.pool.validate()
    assert sched.pool.live_requests() == []


def _prefix_trace(side):
    cfg = _weights("smollm_360m")[side.name][0]
    rng = np.random.default_rng(17)
    base = rng.integers(0, cfg.vocab, size=(8,)).astype(np.int32)
    trace, t = [], 0.0
    for rid in range(8):
        t += 0.05  # light load: only the cache score can keep a session together
        ext = rng.integers(0, cfg.vocab, size=(4,)).astype(np.int32)
        prompt = base if rid % 2 == 0 else np.concatenate([base, ext])
        trace.append(side.traffic.ClientRequest(rid, t, prompt, 4, session=rid % 2))
    return trace


def test_prefix_aware_routing_reuses_cached_blocks():
    """Repeat prompts land on the engine whose cache holds their prefix:
    hits accrue, and the streams are least-loaded routing's."""
    runs, ll = {}, None
    for side in SIDES:
        cl = _cluster(side, "fleet", n_engines=2, policy="prefix-aware", prefix_cache=True)
        runs[side.name] = (cl, cl.run(_prefix_trace(side)))
    _assert_parity(runs)
    ll = _cluster(PORT, "fleet", n_engines=2).run(_prefix_trace(PORT))
    pa = runs["port"][1]
    assert pa.outputs == ll.outputs
    assert sum(s["prefix_hits"] for s in pa.engine_summaries) >= 6


def test_affinity_keeps_sessions_on_one_engine():
    runs = _run_both("fleet", n_engines=3, policy="affinity",
                     trace_kw=dict(n_requests=10, arrival_rate=20.0, session_reuse=0.6, seed=5))
    _assert_parity(runs)
    cl, res = runs["port"]
    _, trace = _trace(PORT, n_requests=10, arrival_rate=20.0, session_reuse=0.6, seed=5)
    by_session: dict[int, int] = {}
    for r in trace:
        eid = cl.router.assignments[r.rid][-1]
        assert by_session.setdefault(r.session, eid) == eid, r.session
    ll = _cluster(PORT, "fleet", n_engines=3).run(trace)
    assert res.outputs == ll.outputs


def test_impossible_requests_and_families_are_refused():
    cfg = _weights("smollm_360m")["port"][0]
    spec, trace = _trace(PORT, n_requests=2)
    cl = _cluster(PORT, "fleet", n_engines=2, spec=None)
    big = dataclasses.replace(trace[0], prompt=np.zeros((MAX_LEN,), np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="no undrained engine"):
        cl.router.offer(big)
    with pytest.raises(ValueError, match="unknown policy"):
        t_cluster.Router(cl.engines, "random")
    scfg = t_configs.get_smoke_config("mamba2_1p3b")
    with pytest.raises(ValueError, match="wire format"):
        t_cluster.DisaggCluster(scfg, None, n_engines=2, slots=SLOTS, max_len=MAX_LEN,
                                block_tokens=BLOCK, cost=_costs("smollm_360m")["port"],
                                split=(1, 1))
    with pytest.raises(ValueError, match="bad split"):
        _cluster(PORT, "disagg", n_engines=3, split=(3, 0))
    assert cfg.family == "dense"


# ---------------- spans, ledger and tracker over a fleet ----------------


def _stream(mem) -> list[dict]:
    return mem.records + mem.spans


def _traced_both(kind, trace_fn=None, run_kw=None, **kw):
    out = {}
    for side in SIDES:
        mem = side.tracker.MemoryTracker()
        if trace_fn is None:
            spec, trace = _trace(side, n_requests=8, seed=3)
        else:
            spec, trace = None, trace_fn(side)
        cl = _cluster(side, kind, spec=spec, tracker=mem, **kw)
        out[side.name] = (cl, cl.run(trace, **(run_kw or {})), mem)
    return out


def _same_records(a: list[dict], b: list[dict]) -> bool:
    """Two record lists equal, floats within 1e-9."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            return False
        for k, v in x.items():
            w = y[k]
            if isinstance(v, float) and isinstance(w, float):
                if not _same_time(v, w):
                    return False
            elif v != w and not (isinstance(v, (list, tuple)) and list(v) == list(w)):
                return False
    return True


def test_fleet_and_disagg_spans_decompose_and_match_reference():
    """Every completed request's spans tile [submit, done], milestones
    land on span boundaries, pre-first phases sum to the client TTFT; the
    handoff span carries tokens x handoff_s_per_token and the decode side
    resumes there; the span records are the reference's."""
    for kind, n in (("fleet", 2), ("disagg", 3)):
        runs = _traced_both(kind, n_engines=n)
        (jcl, jres, jmem), (cl, res, mem) = runs["ref"], runs["port"]
        _assert_timings_match(jres, res)
        recs = _stream(mem)
        assert t_spans.validate_trace(recs) == []
        assert _same_records(mem.spans, jmem.spans)
        events = t_spans.request_events(recs)
        by_rid = t_spans.request_spans(recs)
        assert set(events) == set(res.outputs) == set(by_rid)
        for rid, timing in res.timings.items():
            ev = events[rid]
            assert _same_time(ev["first"], timing.t_first) and _same_time(ev["done"], timing.t_done)
            assert by_rid[rid][0]["phase"] == "queue"
            assert _same_time(by_rid[rid][0]["t0"], timing.t_arrival)
            pre = math.fsum(s["t1"] - s["t0"] for s in by_rid[rid] if s["t1"] <= ev["first"])
            assert abs(pre - timing.ttft) <= TIME_TOL
        for rid, agg in t_spans.decompose(recs).items():
            assert abs(math.fsum(agg.values()) - (events[rid]["done"] - by_rid[rid][0]["t0"])) < 1e-9
        if kind == "disagg":
            cost = _costs("smollm_360m")["port"]
            hand = [s for s in mem.spans if s["phase"] == "handoff"]
            assert len(hand) == len(res.outputs)
            for s in hand:
                assert s["role"] == "prefill"
                assert abs((s["t1"] - s["t0"]) - s["tokens"] * cost.handoff_s_per_token) <= 1e-9
            for spans in by_rid.values():
                roles = [s["role"] for s in spans]
                assert roles[0] == "prefill" and "decode" in roles


def test_fleet_drain_requeue_timeline_still_tiles():
    """Requests drained mid-flight restart elsewhere; their aborted visits
    are excluded and the surviving timelines still tile [submit, done]."""

    def burst(side):
        rng = np.random.default_rng(11)
        fresh = lambda k: rng.integers(0, 512, size=(k,)).astype(np.int32)  # noqa: E731
        return [side.traffic.ClientRequest(i, 0.001 * i, fresh(int(rng.integers(8, 15))),
                                           int(rng.choice((4, 8))), i) for i in range(8)]

    runs = _traced_both("fleet", trace_fn=burst, run_kw=dict(drain_at=(0, 0.0035)), n_engines=2,
                        policy="prefix-aware", prefix_cache=True)
    (_, jres, jmem), (cl, res, mem) = runs["ref"], runs["port"]
    _assert_timings_match(jres, res)
    assert len(res.outputs) == 8 and res.outputs == jres.outputs
    recs = _stream(mem)
    assert t_spans.validate_trace(recs) == []
    aborted = [s for s in mem.spans if s.get("aborted")]
    assert len(aborted) == len([s for s in jmem.spans if s.get("aborted")])
    surv = t_spans.request_spans(recs)
    for s in aborted:
        assert all(x["engine"] != s["engine"] for x in surv.get(s["rid"], []))


def test_fleet_ledger_and_tracker_stream_replay_per_engine():
    """A drain, a restore and a second trace over one shared stream: the
    ledger stays exact (``validate_ledger``), every engine's rounds replay
    to its summary, every completion shows as a virtual-time ``done``
    event, the mem summaries surface per engine and fleet-wide, and the
    records are the reference's."""
    streams = {}
    for side in SIDES:
        mem = side.tracker.MemoryTracker()
        cl = _cluster(side, "fleet", n_engines=2, policy="prefix-aware", prefix_cache=True,
                      tracker=mem)
        spec1 = _spec(side, 512, n_requests=8, prompt_lens=((6, 0.5), (10, 0.5)),
                      gen_lens=((4, 1.0),), seed=3)
        res1 = cl.run(side.cluster.synthesize(spec1), drain_at=(0, 0.0005))
        cl.restore_engine(0)
        spec2 = _spec(side, 512, n_requests=6, prompt_lens=((6, 1.0),), gen_lens=((4, 1.0),),
                      seed=4)
        trace2 = [dataclasses.replace(r, rid=r.rid + 8) for r in side.cluster.synthesize(spec2)]
        res2 = cl.run(trace2)
        streams[side.name] = (cl, res1, res2, mem)
    jcl, jres1, jres2, jmem = streams["ref"]
    cl, res1, res2, mem = streams["port"]
    assert (res1.outputs, res2.outputs) == (jres1.outputs, jres2.outputs)
    assert len(res1.outputs) == 8 and len(res2.outputs) == 14
    _assert_timings_match(jres2, res2)
    assert t_mem.validate_ledger(mem.stream) == []
    assert _same_records(mem.mems, jmem.mems)
    done = {rid for r in mem.records for kind, rid, _ in r.get("events", ()) if kind == "done"}
    assert done == set(res2.outputs)
    assert len(mem.hparams) == 2  # one per engine
    for e in cl.engines:
        rep = t_tracker.replay_summary(mem.stream, engine=e.engine_id)
        summ = e.summary()
        for key in ("completed", "handoffs", "prefill_steps", "prefill_tokens", "decode_steps",
                    "generated_tokens"):
            assert rep[key] == summ[key], (e.engine_id, key)
        assert rep["clock_s"] == pytest.approx(summ["clock_s"], abs=1e-5)
        assert summ["mem"]["observed"] > 0 and 0.0 < summ["mem"]["peak_occupancy"] <= 1.0
        assert summ["fragmentation"].keys() == {"baseline_blocks", "ffd_blocks",
                                                "baseline_efficiency", "ffd_efficiency"}
    ms = res2.mem_summary
    assert ms["signal"] in ("ok", "pressure", "storm") and ms["peak_occupancy"] > 0.0
    assert ms == jres2.mem_summary
    assert sorted(a["engine"] for a in mem.mems if a["op"] == "attach") == [0, 1]
    assert t_mem.summarize_ledger(mem.stream)["engines"] == t_mem.summarize_ledger(
        jmem.stream)["engines"]


# ---------------- the CLI ----------------


@pytest.mark.parametrize("mode", ["single", "fleet", "disagg"])
def test_fleet_cli_smoke_on_the_cpu(mode, tmp_path, capsys):
    out, trace = tmp_path / "fleet.json", tmp_path / "fleet.jsonl"
    argv = ["--smoke", "--device", "cpu", "--mode", mode, "--engines", "3", "--requests", "12",
            "--json", str(out), "--trace-out", str(trace)]
    assert fleet.main(argv) == 0
    text = capsys.readouterr().out
    assert f"[fleet/{mode}]" in text and "12/12 requests" in text
    doc = json.loads(out.read_text())
    assert doc["report"]["completed"] == 12 and doc["engines"] == (1 if mode == "single" else 3)
    records = t_tracker.read_jsonl(trace)
    assert t_spans.validate_trace(records) == [] and t_mem.validate_ledger(records) == []
    for s in doc["engine_summaries"]:
        rep = t_tracker.replay_summary(records, engine=s["engine"])
        assert all(rep[k] == s[k] for k in ("completed", "handoffs", "decode_steps"))
    if mode == "disagg":
        assert doc["split"] == [1, 2] and "Eq. 2 provisioned" in text
        assert sum(s["handoffs"] for s in doc["engine_summaries"]) == 12


def test_fleet_cli_refusals(capsys):
    assert fleet.main(["--arch", "no_such_arch", "--smoke", "--device", "cpu"]) == 2
    assert fleet.main(["--arch", "mamba2_1p3b", "--smoke", "--device", "cpu"]) == 2
    assert "no paged serving path" in capsys.readouterr().out
    assert fleet.main(["--smoke", "--device", "cpu", "--mode", "disagg", "--engines", "2",
                       "--split", "2,1", "--requests", "2"]) == 2
    assert "bad split" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.main(["--smoke", "--requests", "2"])
