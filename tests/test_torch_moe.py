"""Port parity for the MoE family's serving path: ``models.moe``'s dropless
dispatch, the MoE branches of the serve entry points, the scheduler's
expert tallies and gauges, the expert residency plan and budgeted serving,
the prefix cache, n-gram speculation, ``interop`` and the configs, each
against ``repro`` on the reference's own weights (olmoe's smoke config,
float32, on the CPU)."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import speculative as jspec  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.prefix_cache import PrefixCache as JCache  # noqa: E402
from repro.runtime.residency import plan as jplan  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro.runtime.tracker import MemoryTracker as JTracker  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import PORTED_FAMILIES  # noqa: E402
from repro_torch.runtime import speculative as tspec  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache as TCache  # noqa: E402
from repro_torch.runtime.residency import executor as texec  # noqa: E402
from repro_torch.runtime.residency import plan as tplan  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402
from repro_torch.runtime.tracker import MemoryTracker as TTracker  # noqa: E402
from repro_torch.runtime.tracker import replay_summary  # noqa: E402

# the reference's serving parity tolerance (tests/test_torch_lm.py)
RTOL, ATOL = 1e-4, 1e-5
ARCH = "olmoe_1b_7b"
SLOTS, MAX_LEN, BLOCK, CHUNK = 3, 40, 4, 12
# mixed prompt lengths: 17 and 21 exceed the prefill chunk and prefill in
# chunks across rounds; 5, 9, 3 pad to a block-multiple bucket
PROMPT_LENS = (5, 17, 9, 3, 21, 12)
GEN = (6, 4, 8, 5, 3, 7)
COUNTERS = ("completed", "generated_tokens", "prefill_steps", "prefill_tokens",
            "decode_steps", "rounds", "expert_tokens")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """(jc, tc, jp, tp): olmoe's smoke config and the reference's draw,
    carried into the port byte for byte."""
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jlm.init_params(jc, jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _layer(jp, tp, i=0):
    jl = jax.tree.map(lambda a: a[i], jp["layers"])
    return jl, tp.layer(i)


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


# ---------------- configs and interop ----------------


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonshot_v1_16b_a3b"])
def test_moe_configs_match_reference(arch):
    assert dataclasses.asdict(t_full(arch)) == dataclasses.asdict(j_full(arch))
    assert dataclasses.asdict(t_smoke(arch)) == dataclasses.asdict(j_smoke(arch))
    assert t_full(arch).family == "moe" and "moe" in PORTED_FAMILIES


def test_init_params_moe_shapes_follow_reference():
    """The port's own draw has the reference's leaves, shapes and dtypes:
    a router (L, d, E) in f32 and stacked dense experts, never packed, at
    any ``w_bits``."""
    for w_bits in (0, 2):
        jc = dataclasses.replace(j_smoke(ARCH), w_bits=w_bits, dtype="bfloat16")
        tc = dataclasses.replace(t_smoke(ARCH), w_bits=w_bits, dtype="bfloat16")
        want = jax.eval_shape(lambda: jlm.init_params(jc, jax.random.key(0)))
        got = tlm.init_params(tc, seed=1, device="cpu").tree()
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat_w) == sum(1 for _ in _leaves(got))
        for path, leaf in flat_w:
            keys = [p.key for p in path]
            t = got
            for k in keys:
                t = t[k]
            assert tuple(t.shape) == tuple(leaf.shape), keys
            assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), keys
        assert got["layers"]["router"].dtype == torch.float32
        assert not isinstance(got["layers"]["w1"], dict)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_router_stays_f32_through_interop(weights):
    """``params_from_reference(..., dtype=bf16)`` rounds the expert weights
    and keeps the router in f32, as the reference keeps it; the round trip
    gives the reference's tree back, byte for byte."""
    jc, tc, jp, _ = weights
    tree = jax.tree.map(np.asarray, jp)
    bf = params_from_reference(tree, tc, device="cpu", dtype=torch.bfloat16)
    assert bf.layers.router.dtype == torch.float32
    assert torch.equal(bf.layers.router, _t(tree["layers"]["router"]))
    assert bf.layers.w1.dtype == torch.bfloat16
    back = params_to_reference(params_from_reference(tree, tc, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # experts are dense at any w_bits, so a packed-config MoE tree is taken
    params_from_reference(tree, dataclasses.replace(tc, w_bits=2), device="cpu")


# ---------------- models.moe ----------------


def test_token_gates_match_reference(weights):
    jc, tc, jp, tp = weights
    jl, tl = _layer(jp, tp)
    x = _x(jc, 3, 7, 0)
    gate_j, probs_j, onehot_j = jmoe._token_gates(jnp.asarray(x), jl["router"], jc)
    gate_t, probs_t, top_i = tmoe._token_gates(_t(x), tl["router"], tc)
    _close(probs_t, probs_j)
    _close(gate_t, gate_j)
    # the same experts chosen, and the counts the reference's one-hot sum
    chosen_j = np.asarray(onehot_j).sum(axis=2) > 0
    assert np.array_equal((gate_t > 0).numpy(), chosen_j)
    np.testing.assert_array_equal(
        tmoe.expert_counts(top_i, tc.n_experts).numpy(),
        np.asarray(onehot_j).sum(axis=(0, 1, 2)))


@pytest.mark.parametrize("masked", [False, True], ids=["resident", "streamed"])
def test_moe_ffn_dropless_matches_reference(weights, masked):
    """Output within the tolerance of the reference's, counts exact; with
    a stream mask (every other expert cold) the port's output is bitwise
    its unmasked output (the plain ``stream_matmul`` is the resident
    arithmetic on the CPU) and the reference's masked output."""
    jc, tc, jp, tp = weights
    jl, tl = _layer(jp, tp, 1)
    x = _x(jc, 2, 6, 1)
    mask = tuple(e % 2 == 1 for e in range(tc.n_experts)) if masked else None
    want, wc = jmoe.moe_ffn_dropless(
        jnp.asarray(x), jl["router"], jl["w1"], jl["w3"], jl["w2"], jc,
        stream_mask=None if mask is None else jnp.asarray(mask),
    )
    got, gc = tmoe.moe_ffn_dropless(_t(x), tl["router"], tl["w1"], tl["w3"], tl["w2"], tc,
                                    stream_mask=mask)
    _close(got, want)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert float(gc.sum()) == 2 * 6 * tc.experts_per_token
    plain, pc = tmoe.moe_ffn_dropless(_t(x), tl["router"], tl["w1"], tl["w3"], tl["w2"], tc)
    assert torch.equal(got, plain) and torch.equal(gc, pc)
    with pytest.raises(ValueError, match="flags for"):
        tmoe.moe_ffn_dropless(_t(x), tl["router"], tl["w1"], tl["w3"], tl["w2"], tc,
                              stream_mask=(True,))


def test_streamed_bf16_rows_compute_the_f32_product(weights):
    """A cold expert streams its bf16 rows as stored where the reference
    streams their f32 cast: the cast is exact, so the plain product is
    bitwise the resident one on the f32 weights."""
    _, tc, _, tp = weights
    tl = tp.layer(0)
    x = _t(_x(tc, 1, 5, 2)).reshape(5, tc.d_model)
    w = tl["w1"][3].to(torch.bfloat16)
    streamed = tmoe._streamed(x, w, tl["w3"][3].to(torch.bfloat16),
                              tl["w2"][3].to(torch.bfloat16), 2)
    resident = tmoe._resident(x, w.float(), tl["w3"][3].to(torch.bfloat16).float(),
                              tl["w2"][3].to(torch.bfloat16).float())
    assert torch.equal(streamed, resident)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 96, 256, 300, 600])
def test_prefill_sized_products_run_in_256_row_calls(m):
    """With ``fixed`` (a prefill's products) every f32 product call runs
    in 256-row calls, the last padded with zero rows, whatever its row
    count (on the card cuBLAS picks its f32 GEMM by the row count, so a
    row's bits would follow M); the rows are the unpadded call's. Without
    it (decode, verify) the call runs as it is."""
    rng = np.random.default_rng(m)
    x = _t(rng.normal(size=(m, 24)).astype(np.float32))
    w = _t(rng.normal(size=(24, 10)).astype(np.float32))
    for fixed in (True, False):
        seen = []

        def fn(t):
            seen.append(t.shape[0])
            return t @ w

        got = tmoe._fixed_rows(fn, x, fixed)
        np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), rtol=1e-6, atol=1e-6)
        assert tuple(got.shape) == (m, 10)
        assert seen == ([tmoe.EXPERT_ROWS] * -(-m // 256) if fixed else [m])


def test_only_prefill_entry_points_pad_their_products(weights, monkeypatch):
    """A 16-token prompt bucket and a chunk run every f32 product (router
    and resident experts) in 256-row calls, so the K/V rows they commit
    have the bits a longer prompt's prefill gives them; decode and verify
    steps run their rows unpadded."""
    _, tc, _, tp = weights
    calls = []
    inner = tmoe._fixed_rows

    def spy(fn, x, fixed):
        def rows(t):
            calls.append(t.shape[0])
            return fn(t)
        return inner(rows, x, fixed)

    monkeypatch.setattr(tmoe, "_fixed_rows", spy)
    rng = np.random.default_rng(11)
    per_layer = tc.n_layers * (1 + tc.n_experts)  # the router, then each expert
    tokens = _t(rng.integers(0, tc.vocab, size=(1, 16)))
    tlm.prefill_with_cache(tp, tc, tokens, 15)
    assert calls == [tmoe.EXPERT_ROWS] * per_layer
    pk, pv = (_t(a) for a in _pool(tc, 40, 12))
    table = _t((4 + np.arange(32)).reshape(2, 16))
    calls.clear()
    tlm.prefill_chunk_paged(tp, tc, tokens[:, :8], pk, pv, table[:1], table[:1, 3:11], 3, 7)
    assert calls == [tmoe.EXPERT_ROWS] * per_layer
    calls.clear()
    tlm.decode_step_paged(tp, tc, tokens[:, :2].reshape(2, 1), pk, pv, table, _t([5, 9]))
    assert calls == [2] * per_layer
    calls.clear()
    write = torch.stack([table[0, 5:9], table[1, 9:13]])
    tlm.verify_chunk_paged(tp, tc, tokens[:, :8].reshape(2, 4), pk, pv, table, write,
                           _t([5, 9]))
    assert calls == [8] * per_layer


@pytest.mark.parametrize("seed,b", [(0, 2), (1, 3), (2, 4)])
def test_moe_dropless_routing_is_batch_independent(weights, seed, b):
    """A row's output and routing do not depend on what shares its batch
    (the reference's property test): each batch row alone gives the same
    bits, and every token routes exactly top_k slots."""
    _, tc, _, tp = weights
    tl = tp.layer(0)
    x = _t(_x(tc, b, 5, 10 + seed))
    out, counts = tmoe.moe_ffn_dropless(x, tl["router"], tl["w1"], tl["w3"], tl["w2"], tc)
    for i in range(b):
        solo, _ = tmoe.moe_ffn_dropless(x[i:i + 1], tl["router"], tl["w1"], tl["w3"],
                                        tl["w2"], tc)
        assert torch.equal(out[i], solo[0]), f"row {i} follows its batch"
    assert float(counts.sum()) == b * 5 * tc.experts_per_token


# ---------------- the serve entry points' MoE branches ----------------


def _pool(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, rows, cfg.n_kv, cfg.hd)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.fixture(scope="module")
def moonshot():
    jc, tc = j_smoke("moonshot_v1_16b_a3b"), t_smoke("moonshot_v1_16b_a3b")
    jp = jlm.init_params(jc, jax.random.key(1))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch", ["olmoe", "moonshot"])
def test_moe_prefill_with_cache_matches_reference(weights, moonshot, arch):
    jc, tc, jp, tp = weights if arch == "olmoe" else moonshot
    tokens = np.random.default_rng(3).integers(0, jc.vocab, size=(2, 12)).astype(np.int32)
    lg_j, ks_j, vs_j, c_j = jlm.prefill_with_cache(jp, jc, jnp.asarray(tokens), 9)
    lg_t, ks_t, vs_t, c_t = tlm.prefill_with_cache(tp, tc, _t(tokens), 9)
    _close(lg_t, lg_j)
    _close(ks_t, ks_j)
    _close(vs_t, vs_j)
    assert tuple(c_t.shape) == (tc.n_layers, tc.n_experts)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("budget", [None, "half"])
def test_moe_decode_step_paged_matches_reference(weights, budget):
    """The decode step, unbudgeted and under an (L, E) mask: logits, the
    K/V rows written, the tally exact; the masked step bitwise the
    unmasked one on the CPU."""
    jc, tc, jp, tp = weights
    s_max, b = 16, 3
    pk, pv = _pool(jc, b * s_max + 4, 4)
    table = (4 + np.arange(b * s_max)).reshape(b, s_max).astype(np.int32)
    lengths = np.array([3, 9, 14], np.int32)
    token = np.random.default_rng(5).integers(0, jc.vocab, size=(b, 1)).astype(np.int32)
    mask = None
    if budget:
        mask = tuple(tuple((l + e) % 3 == 0 for e in range(tc.n_experts))
                     for l in range(tc.n_layers))
    out_j = jlm.decode_step_paged(
        jp, jc, jnp.asarray(token), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(lengths), stream_mask=None if mask is None else jnp.asarray(mask))
    tk, tv = _t(pk), _t(pv)
    out_t = tlm.decode_step_paged(tp, tc, _t(token), tk, tv, _t(table), _t(lengths),
                                  stream_mask=mask)
    for got, want in zip(out_t[:3], out_j[:3]):
        _close(got, want)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    if mask is not None:
        k2, v2 = _t(pk), _t(pv)
        plain = tlm.decode_step_paged(tp, tc, _t(token), k2, v2, _t(table), _t(lengths))
        assert all(torch.equal(a, c) for a, c in zip(out_t, plain))
        with pytest.raises(ValueError, match="shape"):
            tlm.decode_step_paged(tp, tc, _t(token), k2, v2, _t(table), _t(lengths),
                                  stream_mask=(True,) * tc.n_layers)


def test_moe_prefill_chunk_paged_matches_reference(weights):
    jc, tc, jp, tp = weights
    pk, pv = _pool(jc, 28, 6)
    table = (4 + np.arange(24))[None].astype(np.int32)
    tokens = np.random.default_rng(7).integers(0, jc.vocab, size=(1, 8)).astype(np.int32)
    write = table[:, 5:13]
    out_j = jlm.prefill_chunk_paged(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(write), jnp.asarray(5, jnp.int32), jnp.asarray(6, jnp.int32))
    out_t = tlm.prefill_chunk_paged(tp, tc, _t(tokens), _t(pk), _t(pv), _t(table),
                                    _t(write), 5, 6)
    for got, want in zip(out_t[:3], out_j[:3]):
        _close(got, want)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))


def test_moe_verify_chunk_paged_matches_reference(weights):
    jc, tc, jp, tp = weights
    s_max, b, c = 16, 2, 4
    pk, pv = _pool(jc, b * s_max + 4, 8)
    table = (4 + np.arange(b * s_max)).reshape(b, s_max).astype(np.int32)
    starts = np.array([3, 10], np.int32)
    write = np.stack([table[i, s:s + c] for i, s in enumerate(starts)])
    tokens = np.random.default_rng(9).integers(0, jc.vocab, size=(b, c)).astype(np.int32)
    out_j = jlm.verify_chunk_paged(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(write), jnp.asarray(starts))
    out_t = tlm.verify_chunk_paged(tp, tc, _t(tokens), _t(pk), _t(pv), _t(table),
                                   _t(write), _t(starts))
    for got, want in zip(out_t[:3], out_j[:3]):
        _close(got, want)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))


# ---------------- the scheduler ----------------


def _prompts(cfg, lens=PROMPT_LENS, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=p).astype(np.int32) for p in lens]


def _sched(side, w, *, slots=SLOTS, max_len=MAX_LEN, cached=False, **kw):
    jc, tc, jp, tp = w
    if side == "ref":
        pool = JPool.for_slots(jc, slots=slots, max_len=max_len, block_tokens=BLOCK)
        cache = JCache(pool) if cached else None
        return JSched(jc, jp, pool, slots=slots, max_len=max_len, prefix_cache=cache, **kw)
    pool = TPool.for_slots(tc, slots=slots, max_len=max_len, block_tokens=BLOCK, device="cpu")
    cache = TCache(pool) if cached else None
    return TSched(tc, tp, pool, slots=slots, max_len=max_len, prefix_cache=cache, **kw)


def _serve(sched, prompts, gen=GEN):
    for p, g in zip(prompts, gen if not isinstance(gen, int) else [gen] * len(prompts)):
        sched.submit(p, g)
    stats = sched.run()
    return sched.outputs(), stats


@pytest.mark.parametrize("sampling", [dict(), dict(temperature=0.9, top_k=20, seed=7)],
                         ids=["greedy", "seeded"])
def test_moe_scheduler_streams_match_reference(weights, sampling):
    """Chunked over-chunk prompts, padded buckets and staggered lanes: the
    streams, the counters and the tally equal the reference's; the round
    records' MoE gauges are the reference's."""
    jc, tc, _, _ = weights
    jt, tt = JTracker(), TTracker()
    kw = dict(prefill_chunk=CHUNK)
    want, ws = _serve(_sched("ref", weights, sampling=jlm.SamplingParams(**sampling),
                             tracker=jt, **kw), _prompts(jc))
    tsched = _sched("port", weights, sampling=tlm.SamplingParams(**sampling), tracker=tt, **kw)
    got, gs = _serve(tsched, _prompts(tc))
    assert got == want
    for name in COUNTERS:
        assert getattr(gs, name) == getattr(ws, name), name
    assert gs.prefill_steps > len(PROMPT_LENS)  # chunked prefill ran
    assert gs.expert_tokens % (tc.experts_per_token * tc.n_layers) == 0
    keys = ("moe_expert_entropy", "moe_hot_expert_fraction", "expert_tokens")
    assert [{k: r.get(k) for k in keys} for r in tt.records] == [
        {k: r.get(k) for k in keys} for r in jt.records]
    s = replay_summary(tt.records)
    assert s["expert_tokens"] == gs.expert_tokens
    assert 0.0 < s["moe_expert_entropy"] <= 1.0 and s["moe_hot_expert_fraction"] == 1.0


def test_moe_over_budget_prompt_chunks_token_identical(weights):
    """A prompt over the admission budget chunks: chunked equals the
    single-shot stream, as in the reference, whose tallies the port's
    equal; chunking only adds padded-row slots."""
    jc, tc, _, _ = weights
    long_p = np.random.default_rng(25).integers(0, jc.vocab, size=(24,)).astype(np.int32)
    runs = {}
    for side in ("ref", "port"):
        for budget in (16, 64):
            out, st = _serve(_sched(side, weights, slots=2, max_len=64, token_budget=budget),
                             [long_p], 5)
            runs[side, budget] = (out[0], st.prefill_steps, st.expert_tokens)
    assert runs["port", 16] == runs["ref", 16] and runs["port", 64] == runs["ref", 64]
    assert runs["port", 16][1] == 2 and runs["port", 64][1] == 1
    assert runs["port", 16][0] == runs["port", 64][0]
    assert runs["port", 16][2] >= runs["port", 64][2] > 0


def test_moe_padded_bucket_prefill_token_identical(weights):
    """A 3-token prompt pads to a 4-token bucket; its first token is the
    argmax of an unpadded prefill."""
    _, tc, _, tp = weights
    prompt = _prompts(tc, (3,), seed=7)[0]
    out, st = _serve(_sched("port", weights, slots=2), [prompt], 4)
    assert st.completed == 1 and st.prefill_steps == 1
    lg = tlm.prefill_with_cache(tp, tc, _t(prompt[None]), len(prompt) - 1)[0]
    assert out[0][0] == int(lg[0, 0].argmax())


def test_moe_staggered_lanes_independent(weights):
    """3 requests on 2 lanes: each request's stream equals its stream
    served alone."""
    _, tc, _, _ = weights
    prompts = _prompts(tc, (6, 9, 4), seed=35)
    together, _ = _serve(_sched("port", weights, slots=2), prompts, 5)
    for i, p in enumerate(prompts):
        alone, _ = _serve(_sched("port", weights, slots=2), [p], 5)
        assert together[i] == alone[0], f"request {i} diverged"


# ---------------- the residency plan and budgeted serving ----------------


def test_moe_read_weights_and_expert_mask_match_reference():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    assert tplan.read_weight("L000.e0.w1", tc) == jplan.read_weight("L000.e0.w1", jc) == (
        tc.experts_per_token / tc.n_experts)
    assert tplan.read_weight("L000.w1", t_smoke("smollm_360m")) == 1.0
    blocks = tplan.weight_blocks(tc)
    assert [(b.name, b.rows, b.cols, b.bits_per_weight) for b in blocks] == [
        (b.name, b.rows, b.cols, b.bits_per_weight) for b in jplan.weight_blocks(jc)]
    assert len(blocks) == tc.n_layers * tc.n_experts * 3
    total = sum(b.padded_bytes() for b in blocks)
    for frac in (0.0, 0.5, 1.0):
        got = tplan.compile_residency_plan(tc, vmem_budget_bytes=int(total * frac))
        want = jplan.compile_residency_plan(jc, vmem_budget_bytes=int(total * frac))
        assert got.resident == want.resident and got.bins == want.bins
        assert got.read_weights == want.read_weights
        assert got.expert_stream_mask(tc) == want.expert_stream_mask(jc)
        assert got.stream_mask(tc) == got.expert_stream_mask(tc)
        assert got.streamed_bytes_per_step == pytest.approx(want.streamed_bytes_per_step)
        assert got.streamable_bytes_per_step == pytest.approx(want.streamable_bytes_per_step)
    assert texec.supports_budgeted_decode(tc)
    # experts carry the dense width at any w_bits, as in the reference
    q2 = dataclasses.replace(tc, w_bits=2)
    assert {b.bits_per_weight for b in tplan.weight_blocks(q2)} == {32}


@pytest.mark.parametrize("sampling", [dict(), dict(temperature=0.9, top_k=20, seed=7)],
                         ids=["greedy", "seeded"])
def test_moe_budgeted_serving_token_identical(weights, sampling):
    """A half-budget plan streams some experts: budgeted serving equals
    unbudgeted serving and the reference's budgeted serving; the round
    records carry the streamed experts' gauges, as the reference's."""
    jc, tc, _, _ = weights
    total = sum(b.padded_bytes() for b in tplan.weight_blocks(tc))
    tp_ = tplan.compile_residency_plan(tc, vmem_budget_bytes=total // 2)
    jp_ = jplan.compile_residency_plan(jc, vmem_budget_bytes=total // 2)
    mask = np.asarray(tp_.expert_stream_mask(tc))
    assert mask.any() and not mask.all()
    jt, tt = JTracker(), TTracker()
    prompts = _prompts(tc, (5, 9, 7), seed=6)
    want, _ = _serve(_sched("ref", weights, residency=jp_, tracker=jt,
                            sampling=jlm.SamplingParams(**sampling)), prompts, 6)
    got, _ = _serve(_sched("port", weights, residency=tp_, tracker=tt,
                           sampling=tlm.SamplingParams(**sampling)), prompts, 6)
    plain, _ = _serve(_sched("port", weights, sampling=tlm.SamplingParams(**sampling)),
                      prompts, 6)
    assert got == plain == want
    keys = ("moe_hot_expert_fraction", "moe_streamed_experts", "moe_stream_mask_occupancy")
    assert [{k: r.get(k) for k in keys} for r in tt.records] == [
        {k: r.get(k) for k in keys} for r in jt.records]
    assert tt.records[-1]["moe_streamed_experts"] == int(mask.sum())


# ---------------- the prefix cache ----------------


def test_moe_warm_serving_token_identical(weights):
    """Warm serving equals cold serving and the reference's warm serving:
    a cached prefix's KV is what a cold prefill recomputes under dropless
    routing; the follow-up prefills only its unmatched suffix."""
    jc, tc, _, _ = weights
    rng = np.random.default_rng(12)
    base = rng.integers(0, jc.vocab, size=10).astype(np.int32)  # 10 % BLOCK != 0
    ext = np.concatenate([base, rng.integers(0, jc.vocab, size=6).astype(np.int32)])
    outs = {}
    for side, cached in (("port", False), ("port", True), ("ref", True)):
        s = _sched(side, weights, cached=cached)
        for wave in ([base], [ext]):
            _serve(s, wave, 5)
        outs[side, cached] = s.outputs()
        if cached:
            assert s.stats.prefix_hits == 1 and s.stats.prefix_hit_tokens == 10
            assert s.stats.expert_tokens > 0
        outs[side, cached, "expert_tokens"] = s.stats.expert_tokens
    assert outs["port", True] == outs["port", False] == outs["ref", True]
    assert outs["port", True, "expert_tokens"] == outs["ref", True, "expert_tokens"]


# ---------------- speculative decoding ----------------


def test_moe_ngram_speculation_token_identical(weights):
    """The n-gram drafter on an MoE target: streams equal plain decode's
    and the reference's speculative serving, counters and tally too."""
    jc, tc, jp, tp = weights
    prompts = _prompts(tc, (9, 14, 6), seed=21)
    # a repeated prompt gives the suffix match something to propose
    prompts[0] = np.tile(prompts[0][:3], 3)
    plain, _ = _serve(_sched("port", weights), prompts, 6)
    spec = tspec.build_speculator(tc, tp, tspec.SpecConfig(drafter="ngram", depth=4),
                                  slots=SLOTS, max_len=MAX_LEN, smoke=True)
    jsp = jspec.build_speculator(jc, jp, jspec.SpecConfig(drafter="ngram", depth=4),
                                 slots=SLOTS, max_len=MAX_LEN, smoke=True)
    got, gs = _serve(_sched("port", weights, speculative=spec), prompts, 6)
    want, ws = _serve(_sched("ref", weights, speculative=jsp), prompts, 6)
    assert got == plain == want
    for name in ("verify_steps", "accepted_tokens", "draft_tokens", "expert_tokens"):
        assert getattr(gs, name) == getattr(ws, name), name
    assert gs.accepted_tokens > gs.verify_steps  # some proposals were accepted


def test_moe_target_has_no_twin_drafter():
    tc, jc = t_smoke(ARCH), j_smoke(ARCH)
    opts = tspec.compatible_drafters(tc, smoke=True)
    assert "ngram" in opts and ARCH not in opts
    assert opts == [a for a in jspec.compatible_drafters(jc, smoke=True)
                    if a == "ngram" or a in opts]
    rs = tspec.resolve(tc, tspec.SpecConfig(drafter="ngram"), smoke=True)
    assert rs.draft_cfg is None and not rs.twin
    with pytest.raises(ValueError, match="packed twin"):
        tspec.resolve(tc, tspec.SpecConfig(drafter=ARCH), smoke=True)


# ---------------- the serve entry point ----------------


def _serve_cli(capsys, *extra):
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--prompt-len", "6", "--gen-len", "4", "--max-len", "16", *extra]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    metrics = json.loads(next(l for l in out.splitlines()
                              if l.startswith("[serve/metrics] ")).split(" ", 1)[1])
    return out, metrics


def test_serve_cli_serves_moe(capsys):
    """``--quant`` leaves the experts dense with the reference's note (the
    same tokens as without it); ``--vmem-budget`` streams cold experts with
    the same tokens; the [serve/moe] line reports the tally."""
    out, plain = _serve_cli(capsys)
    assert "[serve/moe]" in out and plain["expert_tokens"] > 0
    assert plain["moe"]["moe_hot_expert_fraction"] == 1.0
    out, quant = _serve_cli(capsys, "--quant", "2")
    assert "note: --quant has no effect on family 'moe'" in out
    assert quant["outputs"] == plain["outputs"]
    out, budget = _serve_cli(capsys, "--vmem-budget", "0.5")
    assert "experts streamed" in out and budget["moe"]["moe_streamed_experts"] > 0
    assert budget["outputs"] == plain["outputs"]
    assert budget["kernel_launches"]["stream_matmul"] == 0  # plain versions on the CPU
