"""Port parity for the hybrid family (zamba2-2.7b): its config, weights,
the three hybrid serve entry points, the pool scheduler with per-lane SSM
state, chunked prefill from a carried state and the prefix cache's
anchors, against the reference (``repro``) on the reference's own weights
(the SMOKE config: 4 Mamba2 layers, the shared block after every 2,
float32), dense and with a 2-bit shared FFN. Float outputs are held at
1e-4 relative, 1e-5 absolute; token streams and integer counters
exactly."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconf  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import memledger as j_mem  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.prefix_cache import PrefixCache as JCache  # noqa: E402
from repro.runtime.residency import plan as jplan  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch import configs as tconf  # noqa: E402
from repro_torch.interop import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import memledger as t_mem  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache as TCache  # noqa: E402
from repro_torch.runtime.residency import plan as tplan  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402
from repro_torch.runtime.steps import make_budgeted_paged_serve_step  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCH = "zamba2_2p7b"
BLOCK, MAX_LEN, SLOTS, GEN = 4, 48, 3, 4
CHUNK = 16  # --prefill-chunk of the scheduler cases: the smoke config's ssm_chunk
REF = (JPool, JCache, JSched, jlm)
PORT = (TPool, TCache, TSched, tlm)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=[0, 2], ids=["dense", "w_bits2"])
def weights(request):
    jc = dataclasses.replace(jconf.get_smoke_config(ARCH), w_bits=request.param)
    tc = dataclasses.replace(tconf.get_smoke_config(ARCH), w_bits=request.param)
    jp = jlm.init_params(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    return {REF: (jc, jp), PORT: (tc, params_from_reference(tree, tc, device="cpu")),
            "tree": tree}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _prompt(rng, n, vocab):
    return rng.integers(0, vocab, size=(n,)).astype(np.int32)


def _lanes_close(t_lane, j_lane):
    assert set(t_lane) == set(j_lane) == set(tlm.LANE_KEYS)
    for key in tlm.LANE_KEYS:
        _close(t_lane[key].numpy(), j_lane[key])


# ---------------- config, weights, pool, plan ----------------


def test_config_and_registry_match_reference():
    for name in (ARCH, "zamba2-2.7b"):
        assert tconf.canonical(name) == jconf.canonical(name) == ARCH
        assert dataclasses.asdict(tconf.get_config(name)) == dataclasses.asdict(
            jconf.get_config(name))
    for t, j in ((tconf.get_config(ARCH), jconf.get_config(ARCH)),
                 (tconf.get_smoke_config(ARCH), jconf.get_smoke_config(ARCH))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.d_inner, t.ssm_heads, t.n_kv_cache_layers) == (
            j.d_inner, j.ssm_heads, j.n_kv_cache_layers)
    full = tconf.get_config(ARCH)
    assert (full.n_layers, full.d_inner, full.ssm_heads, full.n_kv_cache_layers) == (54, 5120, 80, 9)


@pytest.mark.parametrize("w_bits", [0, 2])
def test_init_params_has_the_reference_s_tree(w_bits):
    """Every leaf of the reference's tree (the ``shared`` block's packed
    FFN pair at 2 bits included) with its shape and dtype, in bf16 (the f32
    leaves stay f32)."""
    jc = dataclasses.replace(jconf.get_smoke_config(ARCH), w_bits=w_bits, dtype="bfloat16")
    tc = dataclasses.replace(tconf.get_smoke_config(ARCH), w_bits=w_bits, dtype="bfloat16")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jlm.abstract_params(jc))
    got = tlm.init_params(tc, 0, device="cpu").tree()

    def spec(tree):
        return {k: spec(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tree.items()}

    assert spec(got) == want


def test_pack_ffn_params_is_the_packed_draw():
    tc = tconf.get_smoke_config(ARCH)
    dense = tlm.init_params(tc, 3, device="cpu")
    packed = tlm.init_params(dataclasses.replace(tc, w_bits=2), 3, device="cpu")
    got, want = tlm.pack_ffn_params(dense, 2).tree(), packed.tree()

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v

    want_flat = dict(flat(want))
    assert set(dict(flat(got))) == set(want_flat)
    for name, leaf in flat(got):
        assert torch.equal(leaf, want_flat[name]), name


def test_interop_carries_the_hybrid_tree_both_ways(weights):
    """The reference's tree (the SSM leaves, the f32 ``dt_bias``, ``a_log``,
    ``d_skip`` and ``gate_norm``, the ``shared`` block with its packed pair)
    into the port and back, byte for byte; a bf16 copy keeps those leaves
    f32; a tree packed otherwise than the config is refused."""
    tc, tp = weights[PORT]
    back = params_to_reference(tp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), back, weights["tree"])
    bf = params_from_reference(weights["tree"], tc, device="cpu", dtype=torch.bfloat16)
    layers, shared = bf.tree()["layers"], bf.tree()["shared"]
    for name in ("dt_bias", "a_log", "d_skip", "gate_norm", "ln1"):
        assert layers[name].dtype == torch.float32, name
    assert shared["ln2"].dtype == torch.float32 and shared["wq"].dtype == torch.bfloat16
    assert layers["in_x"].dtype == torch.bfloat16
    other = dataclasses.replace(tc, w_bits=2 if tc.w_bits == 0 else 0)
    with pytest.raises(ValueError, match="shared/w1"):
        params_from_reference(weights["tree"], other, device="cpu")


def test_pool_and_ledger_geometry_match_reference():
    """The pool pages one K/V layer per shared-block application, and the
    ledger's block bytes follow from it."""
    jc, tc = jconf.get_smoke_config(ARCH), tconf.get_smoke_config(ARCH)
    jpool = JPool.for_slots(jc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK)
    tpool = TPool.for_slots(tc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK, device="cpu")
    assert tuple(tpool.k.shape) == tuple(jpool.k.shape) == (
        tc.n_kv_cache_layers, tpool.n_blocks * BLOCK, tc.n_kv, tc.hd)
    assert t_mem.kv_block_bytes(tpool) == j_mem.kv_block_bytes(jpool)
    lane = tlm.init_ssm_lane_state(tc, SLOTS, device="cpu")
    want = jlm.init_ssm_lane_state(jc, SLOTS)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in lane.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_residency_plan_lists_the_shared_blocks(full):
    get = (jconf.get_config, tconf.get_config) if full else (
        jconf.get_smoke_config, tconf.get_smoke_config)
    jc, tc = (dataclasses.replace(g(ARCH), w_bits=2) for g in get)
    want = jplan.weight_blocks(jc)
    got = tplan.weight_blocks(tc)
    assert [(b.name, b.rows, b.cols, b.bits_per_weight) for b in got] == [
        (b.name, b.rows, b.cols, b.bits_per_weight) for b in want]
    assert [tplan.read_weight(b.name, tc) for b in got] == [
        jplan.read_weight(b.name, jc) for b in want]
    plan = tplan.compile_residency_plan(tc, vmem_budget_bytes=0)
    assert plan.read_weights == (tc.n_layers / tc.hybrid_attn_every,) * 3


# ---------------- the three serve entry points ----------------


def test_prefill_with_cache_hybrid_matches_reference(weights):
    (jc, jp), (tc, tp) = weights[REF], weights[PORT]
    tokens = _prompt(np.random.default_rng(1), 21, tc.vocab)[None]  # 21: chunks of 7
    lg_j, ks_j, vs_j, lane_j = jlm.prefill_with_cache_hybrid(jp, jc, jnp.asarray(tokens), 17)
    lg_t, ks_t, vs_t, lane_t = tlm.prefill_with_cache_hybrid(
        tp, tc, torch.from_numpy(tokens), torch.tensor([17]))
    assert ks_t.shape == (tc.n_kv_cache_layers, 1, 21, tc.n_kv, tc.hd)
    _close(lg_t, lg_j)
    _close(ks_t, ks_j)
    _close(vs_t, vs_j)
    _lanes_close(lane_t, lane_j)


def _pool_state(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_kv_cache_layers, rows, cfg.n_kv, cfg.hd)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


def _lane_state(cfg, lanes, seed):
    """A random lane state (leaves (L, lanes, ...)), as prefills leave it."""
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in jlm.init_ssm_lane_state(cfg, lanes).items()}


def test_decode_step_paged_hybrid_matches_reference(weights):
    """Three lanes at different depths, three steps: logits, both pools and
    the lane state, which the port advances in place."""
    (jc, jp), (tc, tp) = weights[REF], weights[PORT]
    rows = 3 * MAX_LEN + 4
    pk, pv = _pool_state(tc, rows, 2)
    lane = _lane_state(jc, 3, 3)
    table = (4 + np.arange(3 * MAX_LEN)).reshape(3, MAX_LEN).astype(np.int32)
    lengths = np.array([5, 17, 30], np.int32)
    j_pk, j_pv, j_lane = jnp.asarray(pk), jnp.asarray(pv), jax.tree.map(jnp.asarray, lane)
    t_pk, t_pv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    t_lane = {k: torch.from_numpy(v.copy()) for k, v in lane.items()}
    rng = np.random.default_rng(4)
    for step in range(3):
        tok = rng.integers(0, tc.vocab, (3, 1)).astype(np.int32)
        lg_j, j_pk, j_pv, j_lane = jlm.decode_step_paged_hybrid(
            jp, jc, jnp.asarray(tok), j_pk, j_pv, jnp.asarray(table),
            jnp.asarray(lengths + step), j_lane)
        lg_t, pk_out, _, lane_out = tlm.decode_step_paged_hybrid(
            tp, tc, torch.from_numpy(tok), t_pk, t_pv, torch.from_numpy(table),
            torch.from_numpy(lengths + step), t_lane)
        assert pk_out is t_pk and lane_out is t_lane  # in place
        _close(lg_t, lg_j)
    _close(t_pk, j_pk)
    _close(t_pv, j_pv)
    _lanes_close(t_lane, j_lane)


def test_prefill_suffix_paged_hybrid_matches_reference_and_single_shot(weights):
    """A 9-token prefix prefilled whole, its K/V rows written to the pool
    and its lane state carried; then the 12-token suffix from start 9 (the
    port's ``start`` a device tensor): logits, pools and lane state against
    the reference's, and the suffix's against a whole 21-token prefill."""
    (jc, jp), (tc, tp) = weights[REF], weights[PORT]
    tokens = _prompt(np.random.default_rng(5), 21, tc.vocab)[None]
    rows = MAX_LEN + 4
    table = (4 + np.arange(MAX_LEN, dtype=np.int32))[None]
    _, ks, vs, lane = tlm.prefill_with_cache_hybrid(tp, tc, torch.from_numpy(tokens[:, :9]), 8)
    pk = torch.zeros((tc.n_kv_cache_layers, rows, tc.n_kv, tc.hd))
    pv = torch.zeros_like(pk)
    pk[:, 4:13], pv[:, 4:13] = ks[:, 0], vs[:, 0]
    j_pk, j_pv = jnp.asarray(pk.numpy()), jnp.asarray(pv.numpy())
    j_lane = {k: jnp.asarray(v.numpy()) for k, v in lane.items()}
    wr = table[:, 9:21]
    lg_j, j_pk, j_pv, j_lane = jlm.prefill_suffix_paged_hybrid(
        jp, jc, jnp.asarray(tokens[:, 9:]), j_pk, j_pv, jnp.asarray(table), jnp.asarray(wr),
        jnp.asarray(9, jnp.int32), jnp.asarray(11, jnp.int32), j_lane)
    lg_t, _, _, lane_t = tlm.prefill_suffix_paged_hybrid(
        tp, tc, torch.from_numpy(tokens[:, 9:]), pk, pv, torch.from_numpy(table),
        torch.from_numpy(wr), torch.tensor([9]), torch.tensor([11]), lane)
    assert lane_t is lane
    _close(lg_t, lg_j)
    _close(pk, j_pk)
    _close(pv, j_pv)
    _lanes_close(lane_t, j_lane)
    lg_all, ks_all, _, lane_all = tlm.prefill_with_cache_hybrid(
        tp, tc, torch.from_numpy(tokens), 20)
    _close(lg_t, lg_all)
    _close(pk[:, 4:25], ks_all[:, 0])
    for key in tlm.LANE_KEYS:
        _close(lane_t[key], lane_all[key])


def test_attention_entry_points_refuse_hybrid(weights):
    """The attention families' entry points do not run a hybrid config as
    if it were dense, and the hybrid entry points refuse the others."""
    tc, tp = weights[PORT]
    z = torch.zeros((1, 1), dtype=torch.int64)
    for fn, args in ((tlm.prefill_with_cache, (z, 0)),
                     (tlm.decode_step_paged, (z, None, None, z, z[0])),
                     (tlm.prefill_chunk_paged, (z, None, None, z, z, 0, 0)),
                     (tlm.verify_chunk_paged, (z, None, None, z, z, z[0]))):
        with pytest.raises(ValueError, match="family 'hybrid' is not ported to it"):
            fn(tp, tc, *args)
    dense = tconf.get_smoke_config("smollm_360m")
    with pytest.raises(ValueError, match="prefill_with_cache_hybrid: family 'dense'"):
        tlm.prefill_with_cache_hybrid(tp, dense, z, 0)


# ---------------- the scheduler ----------------


def _sched(side, weights, *, cached=False, slots=2, chunk=CHUNK, sampling=None, budget=None):
    pool_cls, cache_cls, sched_cls, lm_mod = side
    cfg, params = weights[side]
    kw = {} if side is REF else {"device": "cpu"}
    pool = pool_cls.for_slots(cfg, slots=slots, max_len=MAX_LEN, block_tokens=BLOCK, **kw)
    return sched_cls(cfg, params, pool, slots=slots, max_len=MAX_LEN, prefill_chunk=chunk,
                     token_budget=budget, prefix_cache=cache_cls(pool) if cached else None,
                     sampling=lm_mod.SamplingParams(**(sampling or {})))


def _serve_waves(sched, waves, gen=GEN):
    """Each wave submitted, then run to empty round by round; the pool's
    invariants checked after every round."""
    for wave in waves:
        for p in wave:
            sched.submit(p, gen)
        while sched.queue or any(r is not None for r in sched.active):
            sched.round()
            sched.pool.validate()
    return sched.outputs()


COUNTERS = ("completed", "generated_tokens", "prefill_steps", "prefill_tokens",
            "decode_steps", "prefix_hits", "prefix_hit_tokens")


@pytest.mark.parametrize("sampling", [None, dict(temperature=0.9, top_k=20, seed=5)],
                         ids=["greedy", "seeded"])
def test_scheduler_streams_match_reference(weights, sampling):
    """Prompts shorter than a chunk (whole, unpadded), longer (two full
    chunks) and with a tail (16 + 9), three of them on two lanes at once:
    the streams and counters the reference's."""
    rng = np.random.default_rng(6)
    prompts = [_prompt(rng, n, weights[PORT][0].vocab) for n in (7, 32, 25)]
    out = {}
    for side in (REF, PORT):
        sched = _sched(side, weights, sampling=sampling)
        out[side] = (_serve_waves(sched, [prompts], gen=6),
                     {k: getattr(sched.stats, k) for k in COUNTERS})
    assert out[PORT] == out[REF]
    assert out[PORT][1]["prefill_steps"] == 1 + 2 + 2


def test_chunked_prefill_is_single_shot(weights):
    """The reference's over-budget case: a 24-token prompt chunked 16 + 8
    by the admission budget gives the single-shot stream."""
    prompt = _prompt(np.random.default_rng(7), 24, weights[PORT][0].vocab)
    runs = {}
    for budget in (16, None):
        sched = _sched(PORT, weights, budget=budget, chunk=None)
        runs[budget] = (_serve_waves(sched, [[prompt]]), sched.stats.prefill_steps)
    assert runs[16][1] == 2 and runs[None][1] == 1
    assert runs[16][0] == runs[None][0]


def test_staggered_lanes_are_independent(weights):
    """Lane-resident SSM state and pooled shared-attention K/V keep
    co-resident requests from perturbing each other (three requests on two
    lanes against each alone)."""
    rng = np.random.default_rng(8)
    prompts = [_prompt(rng, n, weights[PORT][0].vocab) for n in (11, 6, 20)]
    together = _serve_waves(_sched(PORT, weights), [prompts])
    for i, p in enumerate(prompts):
        assert together[i] == _serve_waves(_sched(PORT, weights), [[p]])[0], i


def test_warm_serving_resumes_ssm_state(weights):
    """Nested multi-turn prompts (anchors at block-unaligned ends): warm
    serving equals cold serving and the reference's warm serving, with its
    hits and prefill tokens."""
    rng = np.random.default_rng(9)
    vocab = weights[PORT][0].vocab
    t1 = _prompt(rng, 9, vocab)
    t2 = np.concatenate([t1, _prompt(rng, 7, vocab)])
    t3 = np.concatenate([t2, _prompt(rng, 6, vocab)])
    waves = [[t1], [t2], [t3]]
    cold = _serve_waves(_sched(PORT, weights), waves)
    runs = {}
    for side in (REF, PORT):
        sched = _sched(side, weights, cached=True)
        runs[side] = (_serve_waves(sched, waves), {k: getattr(sched.stats, k) for k in COUNTERS})
    assert runs[PORT] == runs[REF]
    assert runs[PORT][0] == cold
    st = runs[PORT][1]
    assert (st["prefix_hits"], st["prefix_hit_tokens"], st["prefill_tokens"]) == (2, 9 + 16, 9 + 7 + 6)


def test_divergent_prompt_misses_its_anchor(weights):
    """A prompt sharing tokens but no committed prompt end has no SSM state
    to resume from: it misses, and serves as cold serving does."""
    rng = np.random.default_rng(10)
    vocab = weights[PORT][0].vocab
    t1 = _prompt(rng, 8, vocab)
    div = np.concatenate([t1[:6], _prompt(rng, 6, vocab)])
    cold = _serve_waves(_sched(PORT, weights), [[t1], [div]])
    sched = _sched(PORT, weights, cached=True)
    assert _serve_waves(sched, [[t1], [div]]) == cold
    assert sched.stats.prefix_hits == 0  # 6 tokens match t1's blocks, no anchor does


def test_followup_resumes_at_the_conversation_end(weights):
    """Completion anchors the lane at the conversation's end (prompt plus
    generated tokens but the last), so the follow-up turn resumes there
    and prefills only its new tokens: warm equals cold and the
    reference's."""
    rng = np.random.default_rng(11)
    vocab = weights[PORT][0].vocab
    base = _prompt(rng, 9, vocab)
    runs = {}
    for side in (REF, PORT):
        sched = _sched(side, weights, cached=True)
        sched.submit(base, GEN)
        sched.run()
        followup = np.concatenate([base, np.asarray(sched.outputs()[0], np.int32),
                                   _prompt(np.random.default_rng(12), 6, vocab)])
        assert sched.prefix_cache.match_tokens(followup, anchor=True) == 9 + GEN - 1
        sched.submit(followup, GEN)
        sched.run()
        runs[side] = (sched.outputs(), {k: getattr(sched.stats, k) for k in COUNTERS})
    assert runs[PORT] == runs[REF]
    cold = _sched(PORT, weights)
    assert _serve_waves(cold, [[base], [followup]]) == runs[PORT][0]
    assert runs[PORT][1]["prefill_tokens"] == 9 + len(followup) - (9 + GEN - 1)


def test_anchors_are_host_copies_the_lanes_do_not_move(weights):
    """An anchor is a copy of the lane at commit time: decode steps that
    advance the lane afterwards leave it as it was."""
    sched = _sched(PORT, weights, cached=True)
    sched.submit(_prompt(np.random.default_rng(13), 10, weights[PORT][0].vocab), 8)
    sched.round()  # the prompt's prefill, its anchor, and decode steps
    cache = sched.prefix_cache
    (anchor,) = [a for n in (cache.root, *cache._nodes) for a in n.anchors]
    assert anchor.n_tokens == 10 and sched.requests[0].output[1:]  # the lane moved on
    snap = {k: v.clone() for k, v in anchor.lane_state.items()}
    sched.run()
    for key in tlm.LANE_KEYS:
        assert torch.equal(anchor.lane_state[key], snap[key])
    assert sched.snapshots == 2 and sched.snapshot_bytes == 2 * sum(
        v.nbytes for v in snap.values())


def test_scheduler_refuses_a_budget_and_speculation(weights):
    tc, tp = weights[PORT]
    pool = TPool.for_slots(tc, slots=2, max_len=MAX_LEN, block_tokens=BLOCK, device="cpu")
    with pytest.raises(ValueError, match="streamable-FFN attention family; got 'hybrid'"):
        make_budgeted_paged_serve_step(tc, (False,) * tc.n_layers, 2)
    with pytest.raises(ValueError, match="family 'hybrid' has no draft-chain rollback path"):
        TSched(tc, tp, pool, slots=2, max_len=MAX_LEN, speculative=object())


# ---------------- the serve entry point ----------------

SERVE = ["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu", "--requests", "3",
         "--batch", "2", "--prompt-len", "20", "--gen-len", "4", "--max-len", "32",
         "--prefill-chunk", "16"]


def test_serve_cli_serves_zamba2(capsys):
    """``serve --arch zamba2-2.7b`` serves its smoke config (20-token
    prompts in chunks of 16 and 4) at --quant 2, with the prefix cache on,
    and prints the ``[serve/hybrid]`` line."""
    assert serve.main(SERVE + ["--quant", "2"]) == 0
    out = capsys.readouterr().out
    m = json.loads(next(l for l in out.splitlines() if l.startswith("[serve/metrics] "))
                   .split(" ", 1)[1])
    assert (m["completed"], m["generated_tokens"], m["prefill_steps"]) == (3, 12, 6)
    assert m["prefix_cache"] and m["hybrid"]["snapshots"] == 6
    assert "[serve/hybrid] lane SSM state" in out


@pytest.mark.parametrize("flags,reason", [
    (["--speculate", "ngram"], "SSM lane state cannot roll back a rejected chain"),
    (["--vmem-budget", "1"], "ssm/hybrid state is out of the residency executor's scope"),
], ids=["speculate", "vmem_budget"])
def test_serve_cli_refuses_speculation_and_a_budget(flags, reason, capsys):
    assert serve.main(SERVE + flags) == 2
    assert reason in capsys.readouterr().out
