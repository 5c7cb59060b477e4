"""Port parity for speculative decoding: ``repro_torch.runtime.speculative``,
``lm.verify_chunk_paged``, the pool's draft brackets and the scheduler's
speculate-and-verify cycle, against ``repro.runtime.speculative`` and the
reference's scheduler on the same numpy weights (``interop``), float32 on
the CPU; the reference's ``tests/test_speculative.py``, case for case.

The invariant is structural token identity: whatever the drafter proposes,
the verifier samples each position from the target's own logits with the
plain decode's rng key (seed, rid, position), so the served stream is the
plain decode's, in the port and in the reference, and the port's counters
(accepted tokens, draft tokens, verify steps) are the reference's.
"""

import dataclasses
import functools
import itertools
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconf  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.runtime import memledger as j_mem  # noqa: E402
from repro.runtime import spans as j_spans  # noqa: E402
from repro.runtime import speculative as jspec  # noqa: E402
from repro.runtime import tracker as j_tracker  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch import configs as tconf  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.runtime import memledger as t_mem  # noqa: E402
from repro_torch.runtime import spans as t_spans  # noqa: E402
from repro_torch.runtime import speculative as tspec  # noqa: E402
from repro_torch.runtime import tracker as t_tracker  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5  # the lm parity tests' tolerance
BLOCK, MAX_LEN, SLOTS, P, GEN = 4, 32, 2, 6, 8
N_REQ = 3  # > SLOTS, so one request staggers in behind the others
# test_torch_lm.py's serving cases: every ported arch's smoke config, and
# h2o-danube reduced with its own head dim of 80
CASES = ("smollm_360m", "llama3p2_1b", "h2o_danube_1p8b", "phi3_medium_14b",
         "h2o_danube_1p8b@d80")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(jp):
    return jax.tree.map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def _ctx(arch="smollm_360m"):
    """The reference's smoke config and ``init_params(key(0))``, and the
    port's config with those weights."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jlm.init_params(jc, jax.random.key(0))
    return jc, tc, jp, params_from_reference(_tree(jp), tc, device="cpu")


def _jpool(cfg):
    return JPool(cfg, n_blocks=1 + SLOTS * MAX_LEN // BLOCK, block_tokens=BLOCK)


def _tpool(cfg):
    return TPool(cfg, n_blocks=1 + SLOTS * MAX_LEN // BLOCK, block_tokens=BLOCK,
                 device="cpu")


def _run(pkg, cfg, params, prompts, sampling, **kw):
    """Serve ``prompts`` (GEN tokens each) on ``pkg``'s scheduler; returns
    the scheduler after its drain."""
    sched_cls, pool = (JSched, _jpool(cfg)) if pkg == "ref" else (TSched, _tpool(cfg))
    sched = sched_cls(cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, sampling=sampling, **kw)
    for p in prompts:
        sched.submit(p, GEN)
    sched.run()
    return sched


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(P,)).astype(np.int32) for _ in range(n)]


def _sampling(greedy, seed):
    if greedy:
        return jlm.SamplingParams(), tlm.SamplingParams()
    kw = dict(temperature=0.9, top_k=32, seed=seed)
    return jlm.SamplingParams(**kw), tlm.SamplingParams(**kw)


def _counters(stats):
    return (stats.accepted_tokens, stats.draft_tokens, stats.verify_steps)


# ---------------- verify_chunk_paged ----------------


def _configs(w_bits, case):
    arch, _, variant = case.partition("@")
    if variant == "d80":
        jc = j_reduced(jconf.get_config(arch), head_dim=80)
        tc = t_reduced(tconf.get_config(arch), head_dim=80)
    else:
        jc, tc = j_smoke(arch), t_smoke(arch)
    return dataclasses.replace(jc, w_bits=w_bits), dataclasses.replace(tc, w_bits=w_bits)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_verify_chunk_paged_matches_reference(w_bits, case):
    """Three lanes at their own depths (under a sliding window, past it)
    score a 4-token chain; lane 1's chain is 2 tokens, padded to the
    scratch row. The full (B, C, V) logits and every written pool row match
    the reference's (the reference op by op in the head-dim-80 case, as
    ``test_torch_lm._reference`` runs it)."""
    jc, tc = _configs(w_bits, case)
    jp = jlm.init_params(jc, jax.random.key(w_bits))
    params = params_from_reference(_tree(jp), tc, device="cpu")
    w, c = jc.sliding_window, 4
    rng = np.random.default_rng(30 + w_bits)
    shape = (jc.n_layers, 48 + 2 * w, jc.n_kv, jc.hd)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    # private rows per lane, every position through start + c a real row
    row_table = np.zeros((3, 16 + w), np.int32)
    row_table[0] = np.arange(4, 20 + w)
    row_table[1] = np.arange(20 + w, 36 + 2 * w)
    row_table[2, :8] = np.arange(40 + 2 * w, 48 + 2 * w)
    starts = np.array([5 + w, 11 + w, 0], np.int32)
    ke = (4, 2, 4)
    write_rows = np.zeros((3, c), np.int32)  # padding -> scratch row 0
    for i, (s, k) in enumerate(zip(starts, ke)):
        write_rows[i, :k] = row_table[i, s:s + k]
    tokens = rng.integers(0, jc.vocab, size=(3, c)).astype(np.int32)
    args = (jp, jc, jnp.asarray(tokens), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(row_table), jnp.asarray(write_rows), jnp.asarray(starts))
    if case.endswith("@d80"):
        with jax.disable_jit():
            lg, jk, jv = jlm.verify_chunk_paged(*args)
    else:
        lg, jk, jv = jlm.verify_chunk_paged(*args)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tlg, tk2, tv2 = tlm.verify_chunk_paged(
        params, tc, torch.from_numpy(tokens), tk, tv, torch.from_numpy(row_table),
        torch.from_numpy(write_rows), torch.from_numpy(starts),
    )
    assert tk2 is tk and tv2 is tv  # the pool is updated in place
    assert tlg.shape == (3, c, tc.padded_vocab) and tlg.dtype == torch.float32
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), rtol=RTOL, atol=ATOL)
    # the scratch row takes the padding's writes in an unspecified order
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:], rtol=RTOL, atol=ATOL)


def test_verify_chunk_paged_is_sequential_decode():
    """A chain verified in one call gives the logits and pool rows of its
    tokens fed one decode step at a time (the port against itself)."""
    _, tc, _, params = _ctx()
    rng = np.random.default_rng(5)
    shape = (tc.n_layers, 40, tc.n_kv, tc.hd)
    pk0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    pv0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    table = torch.arange(4, 36).reshape(2, 16)
    starts = torch.tensor([3, 9])
    tokens = torch.from_numpy(rng.integers(0, tc.vocab, size=(2, 4)))
    rows = torch.stack([table[i, s:s + 4] for i, s in enumerate(starts.tolist())])
    pk, pv = pk0.clone(), pv0.clone()
    lg, _, _ = tlm.verify_chunk_paged(params, tc, tokens, pk, pv, table, rows, starts)
    dk, dv = pk0.clone(), pv0.clone()
    for j in range(4):
        step, _, _ = tlm.decode_step_paged(params, tc, tokens[:, j:j + 1], dk, dv, table,
                                           starts + j)
        np.testing.assert_allclose(lg[:, j].numpy(), step[:, 0].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pk.numpy(), dk.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pv.numpy(), dv.numpy(), rtol=RTOL, atol=ATOL)


def test_verify_chunk_paged_refuses_unported_families():
    _, tc, _, params = _ctx()
    z = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="not ported"):
        tlm.verify_chunk_paged(params, dataclasses.replace(tc, family="hybrid"), z, None, None,
                               z, z, torch.zeros(1))


# ---------------- the property sweep ----------------


class PatternDrafter:
    """Protocol-level drafter for the property sweep (the reference
    test's): proposes the token the plain stream holds at each position
    with probability ``q``, else a token guaranteed wrong, so a random
    acceptance pattern exercises every accept length from 1 (the pending
    token only) to the whole chain, without any model cost."""

    is_model = False

    def __init__(self, oracle, vocab, q, seed):
        self.oracle = oracle  # rid -> the whole plain output
        self.vocab = vocab
        self.q = q
        self.rng = np.random.default_rng(seed)

    def start_lane(self, slot, prompt):
        return 0, 0

    def release_lane(self, slot):
        pass

    def accept(self, slot, n_rows):
        pass

    def propose(self, lanes, k, sampling):
        props = np.zeros((len(lanes), k - 1), np.int32)
        for j, ln in enumerate(lanes):
            out = self.oracle[ln.rid]
            for m in range(k - 1):
                pos = ln.out_len + m
                right = int(out[pos]) if pos < len(out) else 0
                if self.rng.random() < self.q:
                    props[j, m] = right
                else:  # anything in the vocab except the oracle token
                    wrong = int(self.rng.integers(self.vocab - 1))
                    props[j, m] = (right + 1 + wrong) % self.vocab
        return props, 0


def _integrated(records, gauges):
    """The attach baseline plus every ``d_`` delta, as validate_ledger
    integrates them."""
    assert records and records[0]["op"] == "attach"
    state = {k: records[0][k] for k in gauges}
    for r in records[1:]:
        if r.get("op") != "reserve":
            for k in gauges:
                state[k] += r.get("d_" + k, 0)
    return state


@functools.lru_cache(maxsize=None)
def _plain(greedy, seed):
    """The plain (non-speculative) streams of both packages on the sweep's
    prompts: they must agree before speculation is held to them."""
    jc, tc, jp, tp = _ctx()
    js, ts = _sampling(greedy, seed)
    prompts = _prompts(N_REQ, jc.vocab, seed=seed)
    want = _run("ref", jc, jp, prompts, js).outputs()
    got = _run("port", tc, tp, prompts, ts).outputs()
    assert got == want
    return prompts, want


def _spec_run(pkg, drafter, depth, sampling, prompts, cfg, params, probe=None):
    mods = (j_tracker, j_mem) if pkg == "ref" else (t_tracker, t_mem)
    tracker = mods[0].MemoryTracker()
    ledger = mods[1].MemLedger(lambda: 0.0, tracker=tracker)
    spec = (jspec if pkg == "ref" else tspec).Speculator(drafter, depth=depth)
    sched_cls, pool = (JSched, _jpool(cfg)) if pkg == "ref" else (TSched, _tpool(cfg))
    sched = sched_cls(cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, sampling=sampling,
                      speculative=spec, ledger=ledger)
    for p in prompts:
        sched.submit(p, GEN)
    while sched.queue or any(r is not None for r in sched.active):
        sched.round()
        if probe is not None:
            probe(sched)
    ledger.sync()
    ledger.flush()
    return sched, tracker.mems


# (seed, depth, q, greedy): every depth, every acceptance rate, greedy and
# seeded, as the reference's hypothesis sweep draws them
SWEEP = ((0, 2, 0.0, True), (1, 3, 0.35, False), (2, 5, 0.75, True), (3, 5, 1.0, False),
         (4, 2, 1.0, True), (5, 3, 0.0, False), (0, 5, 0.35, False), (3, 3, 0.75, True))


@pytest.mark.parametrize("seed,depth,q,greedy", SWEEP)
def test_random_draft_trees_are_token_identical(seed, depth, q, greedy):
    jc, tc, jp, tp = _ctx()
    js, ts = _sampling(greedy, seed)
    prompts, oracle = _plain(greedy, seed)

    def probe(sched):
        # rollback exactness after every round: the allocator audits clean
        # and no draft-class block outlives its verify cycle
        sched.pool.validate()
        assert not sched.pool.draft_rids()

    ref, ref_mems = _spec_run("ref", PatternDrafter(oracle, jc.vocab, q, seed), depth, js,
                              prompts, jc, jp)
    sched, mems = _spec_run("port", PatternDrafter(oracle, tc.vocab, q, seed), depth, ts,
                            prompts, tc, tp, probe)
    assert sched.outputs() == oracle == ref.outputs(), (depth, q, greedy)
    stats = sched.stats
    assert _counters(stats) == _counters(ref.stats)
    # accepted-token conservation: every decode token came from a verify
    # step (each request's first token comes from its prefill)
    assert stats.accepted_tokens == N_REQ * (GEN - 1)
    per_req = math.ceil((GEN - 1) / depth)
    assert per_req <= stats.verify_steps <= N_REQ * (GEN - 1)
    if q == 1.0:  # every chain accepted whole
        assert stats.verify_steps <= N_REQ * per_req
    if q == 0.0:  # every proposal rejected: one token per lane and cycle
        assert stats.verify_steps >= GEN - 1
    assert stats.draft_tokens > 0 and stats.decode_steps == 0
    assert stats.accepted_per_step == stats.accepted_tokens / stats.verify_steps
    # the ledger integrates to the live pool, draft brackets included, and
    # its records are the reference's
    assert _integrated(mems, t_mem.GAUGES) == t_mem._snapshot(sched.pool)
    assert any(r.get("op") == "draft_grow" for r in mems)
    assert [{k: v for k, v in r.items() if k != "t"} for r in mems] == [
        {k: v for k, v in r.items() if k != "t"} for r in ref_mems]


# ---------------- drafter units ----------------


def test_ngram_drafter_continuation():
    d, jd = tspec.NgramDrafter(), jspec.NgramDrafter()
    cases = [
        # suffix [1, 2] last occurred at index 1 -> continuation 3, 9
        (np.array([7, 1, 2, 3, 9, 1, 2], np.int32), 2, [3, 9]),
        # no earlier occurrence of anything: repeat-last fallback
        (np.array([4, 5, 6], np.int32), 3, [6, 6, 6]),
        # the match runs to the context's end: the continuation crosses
        # into the suffix
        (np.array([1, 2, 8, 1, 2], np.int32), 3, [8, 1, 2]),
        # a continuation shorter than n: padded with its own last token
        (np.array([3, 7, 3], np.int32), 3, [7, 3, 3]),
    ]
    for ctx, n, want in cases:
        np.testing.assert_array_equal(d._continuation(ctx, n), want)
        np.testing.assert_array_equal(jd._continuation(ctx, n), want)
    rng = np.random.default_rng(0)
    for _ in range(50):
        ctx = rng.integers(0, 6, size=rng.integers(2, 40)).astype(np.int32)
        n = int(rng.integers(1, 6))
        np.testing.assert_array_equal(d._continuation(ctx, n), jd._continuation(ctx, n))


@pytest.mark.parametrize("greedy", [False, True], ids=["seeded", "greedy"])
def test_ngram_speculation_token_identical(greedy):
    jc, tc, jp, tp = _ctx()
    js, ts = _sampling(greedy, 3)
    prompts = _prompts(N_REQ, jc.vocab, seed=21)
    plain = _run("port", tc, tp, prompts, ts).outputs()
    spec = tspec.build_speculator(tc, tp, tspec.SpecConfig(drafter="ngram", depth=4),
                                  slots=SLOTS, max_len=MAX_LEN, smoke=True)
    assert not spec.is_model and spec.name == "ngram" and spec.graphs == []
    sched = _run("port", tc, tp, prompts, ts, speculative=spec)
    jsp = jspec.build_speculator(jc, jp, jspec.SpecConfig(drafter="ngram", depth=4),
                                 slots=SLOTS, max_len=MAX_LEN, smoke=True)
    ref = _run("ref", jc, jp, prompts, js, speculative=jsp)
    assert sched.outputs() == plain == ref.outputs()
    assert sched.stats.accepted_tokens == N_REQ * (GEN - 1)
    assert _counters(sched.stats) == _counters(ref.stats)


def test_model_drafter_twin_token_identical():
    jc, tc, jp, tp = _ctx()
    # the lossless pairing: a dequantized target and its re-packed twin
    jdq = jspec.dequantize_ffn_params(jp, 2)
    tdq = tspec.dequantize_ffn_params(tp, 2)
    for name in tlm.FFN_LEAVES:
        np.testing.assert_allclose(tdq.layers.leaf(name).numpy(),
                                   np.asarray(jdq["layers"][name]), rtol=1e-6, atol=0)
    prompts = _prompts(N_REQ, jc.vocab, seed=8)
    plain = _run("port", tc, tdq, prompts, None).outputs()
    spec = tspec.build_speculator(tc, tdq, tspec.SpecConfig("smollm_360m", depth=4, quant=2),
                                  slots=SLOTS, max_len=MAX_LEN, smoke=True)
    assert spec.is_model and spec.name.endswith("@w2")
    assert spec.drafter.k.shape == (tc.n_kv_cache_layers, 1 + SLOTS * MAX_LEN, tc.n_kv, tc.hd)
    sched = _run("port", tc, tdq, prompts, None, speculative=spec)
    jsp = jspec.build_speculator(jc, jdq, jspec.SpecConfig("smollm_360m", depth=4, quant=2),
                                 slots=SLOTS, max_len=MAX_LEN, smoke=True)
    ref = _run("ref", jc, jdq, prompts, None, speculative=jsp)
    assert sched.outputs() == plain == ref.outputs()
    # the twin's logits equal the target's, so every chain is accepted
    # whole: no request needs more than ceil((GEN-1)/depth) cycles
    assert sched.stats.verify_steps <= N_REQ * math.ceil((GEN - 1) / 4)
    assert _counters(sched.stats) == _counters(ref.stats)
    ds = spec.drafter.stats
    assert ds.prefills == N_REQ and ds.decode_steps > 0
    assert spec.drafter.lengths.tolist() == [0] * SLOTS  # every lane released


def test_pool_engine_builds_the_twin_of_a_dequantized_target():
    """serve's engine with ``--speculate smollm_360m --spec-quant 2`` on a
    dequantized target, as chip_smoke phase 5 (c) serves it: ``resolve``
    and ``pack_ffn_params`` build the twin, every chain is accepted whole,
    and the streams are the plain engine's."""
    tc = t_smoke("smollm_360m")
    tdq = tspec.dequantize_ffn_params(tlm.init_params(tc, 0, device="cpu"), 2)
    base = ["--smoke", "--device", "cpu", "--requests", "5", "--gen-len", "9"]
    parse = serve.build_parser().parse_args
    m = serve.run_pool_engine(tc, tdq, parse(base + ["--speculate", "smollm_360m"]),
                              torch.device("cpu"))
    plain = serve.run_pool_engine(tc, tdq, parse(base), torch.device("cpu"))
    assert m["outputs"] == plain["outputs"]
    assert m["speculate"].endswith("@w2") and m["draft_prefills"] == 5
    # every chain accepted whole: each request's 8 tokens after its first
    # in two cycles of 4, each with 3 proposals
    assert m["accepted_tokens"] == 5 * 8 and m["decode_steps"] == 0
    assert m["draft_tokens"] == 5 * 2 * 3


def test_foreign_drafter_on_the_reference_draw():
    """llama3.2-1b's smoke config drafts for smollm's (both vocab 512) on
    the reference's ``init_params(dcfg, key(0))`` draw, carried over."""
    jc, tc, jp, tp = _ctx()
    sc = tspec.SpecConfig("llama3.2-1b", depth=3, quant=2)
    rs, jrs = tspec.resolve(tc, sc, smoke=True), jspec.resolve(jc, jspec.SpecConfig(
        "llama3.2-1b", depth=3, quant=2), smoke=True)
    assert not rs.twin and not jrs.twin
    assert dataclasses.asdict(rs.draft_cfg) == dataclasses.asdict(jrs.draft_cfg)
    draft = params_from_reference(
        _tree(jlm.init_params(jrs.draft_cfg, jax.random.key(0))), rs.draft_cfg, device="cpu")
    prompts = _prompts(N_REQ, jc.vocab, seed=11)
    plain = _run("port", tc, tp, prompts, None).outputs()
    spec = rs.build(tc, tp, slots=SLOTS, max_len=MAX_LEN, draft_params=draft)
    assert spec.drafter.params is draft
    sched = _run("port", tc, tp, prompts, None, speculative=spec)
    ref = _run("ref", jc, jp, prompts, None,
               speculative=jrs.build(jc, jp, slots=SLOTS, max_len=MAX_LEN))
    assert sched.outputs() == plain == ref.outputs()
    assert _counters(sched.stats) == _counters(ref.stats)


def test_twin_packing_round_trips_on_its_own_codebook():
    _, tc, _, tp = _ctx()
    dense = tspec.dequantize_ffn_params(tp, 2)
    first = tspec.pack_ffn_params(tp, 2)
    again = tspec.pack_ffn_params(dense, 2)
    for k in tlm.FFN_LEAVES:
        # re-quantizing the dequantized twin gives the codes back exactly
        # (the codebook is a fixed point); the recomputed scale drifts only
        # by a float sum's epsilon
        a, b = first.layers.leaf(k), again.layers.leaf(k)
        assert torch.equal(a["packed"], b["packed"])
        np.testing.assert_allclose(a["scale"].numpy(), b["scale"].numpy(), rtol=1e-5)
    # the twin shares every other leaf with its target, and a packed leaf
    # passes through (the port's lm.pack_ffn_params refuses one)
    assert first["embed"].data_ptr() == tp["embed"].data_ptr()
    twice = tspec.pack_ffn_params(first, 2)
    assert twice.layers.leaf("w1")["packed"] is first.layers.leaf("w1")["packed"]
    # a packed leaf dequantizes to f32, as the reference's does
    assert tspec.dequantize_ffn_params(first, 2).layers.leaf("w2").dtype == torch.float32


# ---------------- the pool's draft bracket ----------------


def _bracket_run(pool_cls, mods, cfg, **kw):
    tracker = mods[0].MemoryTracker()
    ledger = mods[1].MemLedger(lambda: 0.0, tracker=tracker)
    pool = pool_cls(cfg, n_blocks=1 + SLOTS * MAX_LEN // BLOCK, block_tokens=BLOCK, **kw)
    ledger.attach(pool)
    pool.admit(0, P + GEN)
    pool.note_tokens(0, P)
    return pool, ledger, tracker


def test_pool_draft_bracket_grow_and_rollback():
    jc, tc, _, _ = _ctx()
    pool, ledger, tracker = _bracket_run(TPool, (t_tracker, t_mem), tc, device="cpu")
    jpool, jledger, jtracker = _bracket_run(JPool, (j_tracker, j_mem), jc)
    held, free = pool.blocks_held(0), pool.free_blocks
    for p in (pool, jpool):
        p.begin_draft(0, P + 5)  # grows across a block boundary
    assert set(pool.draft_rids()) == {0}
    assert pool.blocks_held(0) > held
    pool.validate()  # draft growth keeps the audit clean
    for p in (pool, jpool):
        p.end_draft(0, P + 1)  # chain rejected: keep only the pending row
    assert not pool.draft_rids()
    assert pool.free_blocks == free  # the surplus blocks all returned
    pool.validate()
    # a chain accepted into its drafted block keeps that block
    for p in (pool, jpool):
        p.begin_draft(0, P + 4)
        p.end_draft(0, P + 3)
    assert pool.blocks_held(0) == 3 and pool.tokens_held(0) == P + 3
    pool.validate()
    for led in (ledger, jledger):
        led.sync()
        led.flush()
    mems = tracker.mems
    assert any(r["op"] == "draft_grow" and r["owner"] == "draft" for r in mems)
    assert any(r["op"] == "draft_end" and r["owner"] == "draft" for r in mems)
    assert _integrated(mems, t_mem.GAUGES) == t_mem._snapshot(pool)
    assert [{k: v for k, v in r.items() if k != "t"} for r in mems] == [
        {k: v for k, v in r.items() if k != "t"} for r in jtracker.mems]
    pool.release(0)
    pool.validate()
    assert pool.free_blocks == pool.usable_blocks


def test_release_clears_open_draft_bracket():
    _, tc, _, _ = _ctx()
    pool = _tpool(tc)
    pool.admit(0, P + GEN)
    pool.note_tokens(0, P)
    pool.begin_draft(0, P + 4)
    pool.release(0)  # the drain/abort path: the bracket still open
    assert not pool.draft_rids()
    pool.validate()
    assert pool.free_blocks == pool.usable_blocks


def test_validate_catches_a_bracket_out_of_sync():
    _, tc, _, _ = _ctx()
    pool = _tpool(tc)
    pool.admit(0, P + GEN)
    pool.note_tokens(0, P)
    pool.begin_draft(0, P + 4)
    pool._draft[0] = pool.blocks_held(0) + 1
    with pytest.raises(AssertionError, match="draft bracket"):
        pool.validate()


def test_draft_past_the_commitment_raises():
    _, tc, _, _ = _ctx()
    pool = _tpool(tc)
    pool.admit(0, P + 2)
    with pytest.raises(RuntimeError, match="commitment"):
        pool.begin_draft(0, P + 2 + BLOCK)


# ---------------- resolution ----------------


def _resolve_error(cfg_pair, drafter, **kw):
    """Both packages' ``ValueError`` message for the same bad choice, the
    reference's with its list of compatible drafters cut to the port's
    (the reference also lists its vlm arch)."""
    (jc, tc), msgs = cfg_pair, []
    for mod, c in ((jspec, jc), (tspec, tc)):
        with pytest.raises(ValueError) as e:
            mod.resolve(c, mod.SpecConfig(drafter=drafter, **kw), smoke=True)
        msgs.append(str(e.value))
    ref_opts = ", ".join(jspec.compatible_drafters(jc, smoke=True))
    port_opts = ", ".join(tspec.compatible_drafters(tc, smoke=True))
    return msgs[0].replace(ref_opts, port_opts), msgs[1]


def test_resolve_rejects_unknown_drafter_listing_options():
    jc, tc, _, _ = _ctx()
    want, got = _resolve_error((jc, tc), "no_such_arch")
    assert got == want and "ngram" in got
    # whisper is known to both: an enc-dec drafter has no packed twin,
    # refused with the reference's message
    want, got = _resolve_error((jc, tc), "whisper_tiny")
    assert got == want and "family 'encdec'" in got and "packed twin" in got
    # mamba2 is known to both: an ssm drafter has no packed twin, refused
    # with the reference's message (its drafter families cut to the port's)
    want, got = _resolve_error((jc, tc), "mamba2_1p3b")
    assert "family 'ssm'" in got and "packed twin" in got
    assert got == want.replace(str(jspec.MODEL_DRAFT_FAMILIES), str(tspec.MODEL_DRAFT_FAMILIES))


def test_resolve_rejects_unpackable_drafter_family():
    """The reference's olmoe case: a drafter of a family without a packed
    twin (MoE experts never pack); the message is the reference's."""
    jc, tc, _, _ = _ctx()
    with pytest.raises(ValueError, match="packed twin") as want:
        jspec.resolve(jc, jspec.SpecConfig(drafter="olmoe_1b_7b"), smoke=True)
    with pytest.raises(ValueError, match="packed twin") as got:
        tspec.resolve(tc, tspec.SpecConfig(drafter="olmoe_1b_7b"), smoke=True)
    # the reference's message past the drafter's name, its families and
    # options cut to the port's
    ref_opts = ", ".join(jspec.compatible_drafters(jc, smoke=True))
    port_opts = ", ".join(tspec.compatible_drafters(tc, smoke=True))
    want_tail = str(want.value).split(" — ")[1].replace(
        str(jspec.MODEL_DRAFT_FAMILIES), str(tspec.MODEL_DRAFT_FAMILIES)).replace(
        ref_opts, port_opts)
    assert str(got.value).split(" — ")[1] == want_tail


def test_resolve_rejects_vocab_mismatch():
    jc, tc, _, _ = _ctx()
    pair = (dataclasses.replace(jc, vocab=jc.vocab + 1), dataclasses.replace(tc, vocab=tc.vocab + 1))
    want, got = _resolve_error(pair, "smollm_360m")
    assert got == want and "vocab" in got


def test_resolve_rejects_hybrid_target():
    hybrid = j_smoke("zamba2_2p7b")
    with pytest.raises(ValueError, match="roll back") as want:
        jspec.resolve(hybrid, jspec.SpecConfig(drafter="ngram"), smoke=True)
    _, tc, _, _ = _ctx()
    with pytest.raises(ValueError, match="roll back") as got:
        tspec.resolve(dataclasses.replace(tc, family="hybrid"),
                      tspec.SpecConfig(drafter="ngram"), smoke=True)
    assert str(got.value).split(";")[0].replace("('dense', 'moe')", "") == str(
        want.value).split(";")[0].replace("('dense', 'vlm', 'moe')", "")


def test_resolve_rejects_bad_depth_and_quant():
    jc, tc, _, _ = _ctx()
    want, got = _resolve_error((jc, tc), "ngram", depth=1)
    assert got == want and "depth" in got
    want, got = _resolve_error((jc, tc), "ngram", quant=4)
    assert got == want and "carrier" in got


def test_resolve_rejects_a_twin_at_other_bits_than_its_packed_target():
    """A target packed at 1 bit cannot have a 2-bit twin: its carriers are
    shared. The port refuses at resolve time; the reference resolves it,
    then fails on the carriers' shape when the drafter first runs."""
    jc, tc, _, _ = _ctx()
    jc1, tc1 = dataclasses.replace(jc, w_bits=1), dataclasses.replace(tc, w_bits=1)
    with pytest.raises(ValueError, match="packed at 1 bits.*--spec-quant 1"):
        tspec.resolve(tc1, tspec.SpecConfig("smollm_360m", quant=2), smoke=True)
    assert tspec.resolve(tc1, tspec.SpecConfig("smollm_360m", quant=1), smoke=True).twin
    assert tspec.resolve(tc, tspec.SpecConfig("smollm_360m", quant=2), smoke=True).twin
    jp1 = jlm.init_params(jc1, jax.random.key(0))
    spec = jspec.build_speculator(jc1, jp1, jspec.SpecConfig("smollm_360m", quant=2),
                                  slots=SLOTS, max_len=MAX_LEN, smoke=True)
    sched = JSched(jc1, jp1, _jpool(jc1), slots=SLOTS, max_len=MAX_LEN, speculative=spec)
    sched.submit(np.arange(P, dtype=np.int32), GEN)
    with pytest.raises(ValueError, match="does not match"):
        sched.run()


def test_compatible_drafters_cover_packable_families():
    jc, tc, _, _ = _ctx()
    opts = tspec.compatible_drafters(tc, smoke=True)
    assert opts[0] == "ngram"
    assert "smollm_360m" in opts  # the twin itself
    for arch in opts[1:]:
        assert t_smoke(arch).family in tspec.MODEL_DRAFT_FAMILIES
    # the reference's list and families (internvl's smoke twin among the
    # drafters: its vocab is the smoke configs' 512)
    assert opts == jspec.compatible_drafters(jc, smoke=True)
    assert "internvl2_76b" in opts
    assert tspec.SPEC_FAMILIES == jspec.SPEC_FAMILIES
    assert tspec.MODEL_DRAFT_FAMILIES == jspec.MODEL_DRAFT_FAMILIES


def test_speculation_refuses_what_has_no_graphs_or_family():
    _, tc, _, tp = _ctx()
    spec = tspec.build_speculator(tc, tp, tspec.SpecConfig("smollm_360m"), slots=SLOTS,
                                  max_len=MAX_LEN, smoke=True)
    with pytest.raises(ValueError, match="no graphs"):
        spec.use_graphs(None)
    with pytest.raises(ValueError, match="CUDA graphs"):
        TSched(tc, tp, _tpool(tc), slots=SLOTS, max_len=MAX_LEN, speculative=spec,
               compiled=True)
    # a hybrid target: the scheduler refuses it (the port serves dense only)
    with pytest.raises(ValueError):
        TSched(dataclasses.replace(tc, family="hybrid"), tp, _tpool(tc), slots=SLOTS,
               max_len=MAX_LEN, speculative=spec)


# ---------------- telemetry ----------------


def _counter_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _observed(pkg, drafter_name):
    """A traced speculative run on a counter clock: round records, spans
    and ledger records of the package's scheduler."""
    jc, tc, jp, tp = _ctx()
    tr_mod, sp_mod, mem_mod, spec_mod, sched_cls, pool, cfg, params = (
        (j_tracker, j_spans, j_mem, jspec, JSched, _jpool(jc), jc, jp) if pkg == "ref"
        else (t_tracker, t_spans, t_mem, tspec, TSched, _tpool(tc), tc, tp))
    if drafter_name != "ngram":
        params = spec_mod.dequantize_ffn_params(params, 2)
    tr = tr_mod.MemoryTracker()
    clock = _counter_clock()
    spans = sp_mod.SpanRecorder(clock, tracker=tr)
    ledger = mem_mod.MemLedger(clock, tracker=tr)
    spec = spec_mod.build_speculator(cfg, params, spec_mod.SpecConfig(drafter_name, depth=3),
                                     slots=SLOTS, max_len=MAX_LEN, smoke=True)
    sched = sched_cls(cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, speculative=spec,
                      tracker=tr, spans=spans, ledger=ledger)
    rng = np.random.default_rng(4)
    for n, gen in zip((6, 9, 3, 5), (8, 1, 6, 7)):
        sched.submit(rng.integers(0, cfg.vocab, size=n).astype(np.int32), gen)
    stats = sched.run()
    return sched, stats, tr, spans


def _drop(recs, keys):
    return [{k: v for k, v in r.items() if k not in keys} for r in recs]


@pytest.mark.parametrize("drafter", ["ngram", "smollm_360m"])
def test_spec_counters_are_replayable_deltas(drafter):
    for key in ("accepted_tokens", "draft_tokens", "verify_steps"):
        assert key in t_tracker.DELTA_KEYS
    assert t_tracker.delta_coverage_gaps() == []
    js, jstats, jtr, _ = _observed("ref", drafter)
    ts, stats, tr, _ = _observed("port", drafter)
    assert ts.outputs() == js.outputs()
    replay = t_tracker.replay_summary(tr.stream)
    for key in ("accepted_tokens", "draft_tokens", "verify_steps", "generated_tokens",
                "completed"):
        assert replay[key] == getattr(stats, key) == getattr(jstats, key)
    assert stats.accepted_tokens > 0 and stats.verify_steps > 0
    # the round records and the hyperparameters are the reference's
    assert _drop(tr.records, ("ttfts",)) == _drop(jtr.records, ("ttfts",))
    h_got, h_want = dict(tr.hparams[0]), dict(jtr.hparams[0])
    assert h_got.pop("compiled") is False
    assert h_got == h_want and h_got["spec_depth"] == 3
    # the ledger integrates to every round's gauges across rejected chains
    assert t_mem.validate_ledger(tr.stream) == []
    assert _drop(tr.mems, ("t",)) == _drop(jtr.mems, ("t",))
    assert any(r["op"] == "draft_end" for r in tr.mems)


@pytest.mark.parametrize("drafter", ["ngram", "smollm_360m"])
def test_draft_and_verify_spans_tile_each_request(drafter):
    _, _, jtr, _ = _observed("ref", drafter)
    _, _, tr, spans = _observed("port", drafter)
    assert _drop(tr.spans, ("t0", "t1")) == _drop(jtr.spans, ("t0", "t1"))
    phases = {s["phase"] for s in tr.spans}
    assert {"draft", "verify"} <= phases and "decode" not in phases
    events = spans.drain_events()
    stream = tr.stream + [{"kind": "metrics", "events": events}]
    assert t_spans.validate_trace(stream) == []
    dec = t_spans.decompose(stream)
    assert len(dec) == 4
    assert sum(d.get("verify", 0.0) > 0 for d in dec.values()) == 3  # the 1-token one has none
    if drafter != "ngram":  # a model drafter prefills every prompt: a draft span each
        assert all(d.get("draft", 0.0) > 0 for d in dec.values())


# ---------------- the serve entry point ----------------


@pytest.mark.parametrize("argv", [
    ["--speculate", "ngram"],
    ["--speculate", "smollm_360m", "--spec-quant", "2"],
    ["--speculate", "smollm-360m", "--spec-quant", "1", "--quant", "1", "--spec-depth", "3",
     "--temperature", "0.8", "--top-k", "20", "--seed", "1"],
], ids=["ngram", "twin", "twin_q1_seeded"])
def test_serve_cli_speculates(capsys, argv):
    base = ["--smoke", "--device", "cpu", "--requests", "5", "--gen-len", "9"]
    assert serve.main(base + argv) == 0
    out = capsys.readouterr().out
    spec_line = next(l for l in out.splitlines() if l.startswith("[serve/spec] "))
    m = json.loads(next(l for l in out.splitlines() if l.startswith("[serve/metrics] "))
                   .split(" ", 1)[1])
    assert m["speculate"] in spec_line and m["verify_steps"] > 0
    assert m["accepted_tokens"] == 5 * 8 and m["decode_steps"] == 0
    assert m["accepted_per_step"] == m["accepted_tokens"] / m["verify_steps"]
    assert m["verify_graph_lengths"] == [] and m["verify_step_ms_replay"] is None
    assert (m["draft_prefills"] == 5) == (argv[1] != "ngram")
    # the streams are plain decode's
    plain_argv = base + [a for i, a in enumerate(argv)
                         if a in ("--quant", "--temperature", "--top-k", "--seed")
                         or i and argv[i - 1] in ("--quant", "--temperature", "--top-k",
                                                  "--seed")]
    assert serve.main(plain_argv) == 0
    plain = json.loads(next(l for l in capsys.readouterr().out.splitlines()
                            if l.startswith("[serve/metrics] ")).split(" ", 1)[1])
    assert plain["outputs"] == m["outputs"] and plain["speculate"] == ""


@pytest.mark.parametrize("argv,match", [
    (["--smoke", "--speculate", "no_such_arch"], "unknown drafter arch"),
    # full size: the vocabularies differ (49152 / 128256); resolved before
    # any weight is drawn
    (["--speculate", "llama3.2-1b"], "vocab"),
    (["--smoke", "--speculate", "ngram", "--spec-depth", "1"], "depth"),
    (["--smoke", "--speculate", "smollm_360m", "--quant", "1"], "packed at 1 bits"),
])
def test_serve_cli_refuses_a_drafter_with_exit_2(capsys, argv, match):
    assert serve.main(["--device", "cpu"] + argv) == 2
    out = capsys.readouterr().out
    assert out.startswith("[serve] ") and match in out
