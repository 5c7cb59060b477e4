"""Port parity for the radix prefix cache over the refcounted
copy-on-write KV pool: the port's ``PrefixCache`` and ``KVPool`` against the
reference's on the same commit / lookup / evict sequences, and the port's
cached serving against its own cold serving and against the reference's
cached serving on the same weights (smollm_360m SMOKE, float32, dense and
``w_bits=2``, greedy and seeded). Token streams and integer counters are
held exactly; ``KVPool.validate()`` runs after every scheduler round."""

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import memledger as j_mem  # noqa: E402
from repro.runtime import tracker as j_tracker  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.prefix_cache import PrefixCache as JCache  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import memledger as t_mem  # noqa: E402
from repro_torch.runtime import tracker as t_tracker  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache as TCache  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402

BLOCK, MAX_LEN, SLOTS, GEN = 4, 48, 3, 4
REF = (JPool, JCache, JSched, jlm, j_mem, j_tracker)
PORT = (TPool, TCache, TSched, tlm, t_mem, t_tracker)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=[0, 2], ids=["dense", "w_bits2"])
def weights(request):
    jc = dataclasses.replace(j_smoke("smollm_360m"), w_bits=request.param)
    tc = dataclasses.replace(t_smoke("smollm_360m"), w_bits=request.param)
    jp = jlm.init_params(jc, jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return {REF: (jc, jp), PORT: (tc, tp)}


def _prompt(rng, n, vocab):
    return rng.integers(0, vocab, size=(n,)).astype(np.int32)


def _pool(side, cfg, n_blocks=None, slots=SLOTS):
    pool_cls = side[0]
    kw = {} if side is REF else {"device": "cpu"}
    if n_blocks is None:
        return pool_cls.for_slots(cfg, slots=slots, max_len=MAX_LEN, block_tokens=BLOCK, **kw)
    return pool_cls(cfg, n_blocks=n_blocks, block_tokens=BLOCK, **kw)


def _sched(side, weights, *, cached=True, slots=SLOTS, n_blocks=None, sampling=None,
           ledger=False):
    _, cache_cls, sched_cls, lm_mod, mem_mod, tracker_mod = side
    cfg, params = weights[side]
    pool = _pool(side, cfg, n_blocks, slots)
    kw = {}
    if ledger:
        ticks = itertools.count()
        tr = tracker_mod.MemoryTracker()
        kw["ledger"] = mem_mod.MemLedger(lambda: next(ticks) * 1e-3, tracker=tr)
    return sched_cls(
        cfg, params, pool, slots=slots, max_len=MAX_LEN,
        prefix_cache=cache_cls(pool) if cached else None,
        sampling=lm_mod.SamplingParams(**(sampling or {})), **kw,
    )


def _serve_waves(sched, waves, gen=GEN):
    """Each wave submitted, then run to empty round by round; the pool's
    invariants are checked after every round."""
    for wave in waves:
        for p in wave:
            sched.submit(p, gen)
        while sched.queue or any(r is not None for r in sched.active):
            sched.round()
            sched.pool.validate()
    if sched.ledger is not None:
        sched.ledger.sync()
        sched.ledger.flush()
    return sched.outputs()


# ---------------- the radix tree, against the reference's ----------------


def _script_match_insert_and_cap(pool, cache, lane):
    """Full blocks match through the tree; the match is capped at p - 1;
    a mid-block divergence returns the partial block for copy-on-write;
    unrelated prompts miss; a peek leaves the hit counters alone."""
    prompt = np.arange(100, 112, dtype=np.int32)
    pool.admit(0, 12)
    pool.note_tokens(0, 12)
    cache.commit(prompt, pool.blocks_of(0))
    pool.release(0)
    pool.validate()
    ext = np.concatenate([prompt, [7, 8]]).astype(np.int32)
    div, div0 = prompt.copy(), prompt.copy()
    div[9], div0[3] = 999, 999
    out = [cache.lookup(p) for p in (prompt, ext, div, div0, prompt[:1],
                                      np.array([1, 2, 3, 4, 5], np.int32))]
    out.append(cache.match_tokens(prompt))
    return out


def _script_lru_bottom_up(pool, cache, lane):
    """Eviction removes leaves LRU first, freeing exactly the blocks
    nothing else holds; a fresher chain survives an older one."""
    old, new = np.arange(0, 8, dtype=np.int32), np.arange(50, 58, dtype=np.int32)
    for rid, p in ((0, old), (1, new)):
        pool.admit(rid, 8)
        pool.note_tokens(rid, 8)
        cache.commit(p, pool.blocks_of(rid))
        pool.release(rid)
    out = [cache.lookup(np.concatenate([new, [1]]).astype(np.int32)), pool.cached_blocks,
           cache.evict(2)]
    out += [cache.lookup(np.concatenate([p, [1]]).astype(np.int32)) for p in (old, new)]
    pool.validate()
    return out + [pool.free_blocks, pool.cached_blocks]


def _script_zero_gain_anchors(pool, cache, lane):
    """A block-aligned anchor frees nothing when evicted: the evictor takes
    LRU leaves first and keeps it; with nothing else left, anchors yield."""
    anchored, plain = np.arange(0, 8, dtype=np.int32), np.arange(50, 58, dtype=np.int32)
    pool.admit(0, 8)
    pool.note_tokens(0, 8)
    cache.commit(anchored, pool.blocks_of(0), lane_state=lane)
    pool.release(0)
    pool.admit(1, 8)
    pool.note_tokens(1, 8)
    cache.commit(plain, pool.blocks_of(1))
    pool.release(1)
    probe = np.concatenate([anchored, [1]]).astype(np.int32)
    out = [cache.lookup(probe, anchor=True), cache.evict(1),
           cache.lookup(probe, anchor=True), cache.evict(8), pool.cached_blocks]
    pool.validate()
    return out


def _fields(x):
    """A lookup result as comparable fields (the anchor's snapshot by
    presence: the two packages hold the same numpy leaves)."""
    if x is None or not hasattr(x, "matched"):
        return x
    return (x.matched, x.shared, x.tail_block, x.lane_state is not None)


@pytest.mark.parametrize(
    "script", [_script_match_insert_and_cap, _script_lru_bottom_up, _script_zero_gain_anchors],
    ids=["match_insert_and_cap", "lru_bottom_up", "zero_gain_anchors"],
)
def test_prefix_cache_matches_reference(script):
    """The same sequence on both packages: identical ``PrefixMatch``
    fields, eviction counts, ``stats()`` and pool gauges."""
    logs = []
    for side in (REF, PORT):
        cfg = (j_smoke if side is REF else t_smoke)("smollm_360m")
        pool = _pool(side, cfg, n_blocks=33)
        cache = side[1](pool)
        lane = {"ssm": np.zeros((2, 1, 1), np.float32)}
        out = [_fields(x) for x in script(pool, cache, lane)]
        logs.append((out, cache.stats(), dataclasses.asdict(pool.stats()),
                     (pool.alloc_blocks, pool.freed_blocks, pool.cow_copies)))
    assert logs[1] == logs[0]
    assert any(m is not None for m in logs[1][0])


# ---------------- serving, against cold and against the reference ----------------


def _waves(vocab):
    """A base prompt (10 tokens, not block-aligned), then an extension and
    a sibling that diverges mid-block (copy-on-write), co-resident."""
    rng = np.random.default_rng(5)
    base = _prompt(rng, 10, vocab)
    ext = np.concatenate([base, _prompt(rng, 6, vocab)])
    sib = np.concatenate([base[:-1], _prompt(rng, 7, vocab)])
    return [[base], [ext, sib]]


@pytest.mark.parametrize("sampling", [None, dict(temperature=0.8, top_k=16, top_p=0.9, seed=11)],
                         ids=["greedy", "seeded"])
def test_warm_serving_matches_cold_and_reference(weights, sampling):
    cfg = weights[PORT][0]
    waves = _waves(cfg.vocab)
    cold = _serve_waves(_sched(PORT, weights, cached=False, sampling=sampling), waves)
    runs = {}
    for side in (REF, PORT):
        sched = _sched(side, weights, sampling=sampling, ledger=True)
        runs[side] = (sched, _serve_waves(sched, waves))
    (j, j_out), (t, t_out) = runs[REF], runs[PORT]
    assert t_out == cold
    assert t_out == j_out
    # base misses; its completion commits prompt + 3 generated tokens, so
    # ext matches 10 (2 full blocks and 2 tokens copied on write); once
    # ext commits, sib matches 9
    assert (t.stats.prefix_hits, t.stats.prefix_hit_tokens) == (2, 10 + 9)
    assert t.stats.prefill_tokens == 10 + (16 - 10) + (16 - 9)
    for name in ("prefix_hits", "prefix_hit_tokens", "prefill_tokens", "prefill_steps",
                 "decode_steps", "shared_blocks_peak", "rounds"):
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert t.stats.prefix_hit_rate == j.stats.prefix_hit_rate
    assert t.stats.shared_blocks_peak >= 2
    assert (t.pool.cow_copies, t.prefix_cache.evicted_blocks) == (
        j.pool.cow_copies, j.prefix_cache.evicted_blocks)
    assert t.pool.cow_copies == 2
    assert t.prefix_cache.stats() == j.prefix_cache.stats()
    # the ledger: the same records (ops, owners, deltas), the clock aside
    drop = lambda recs: [{k: v for k, v in r.items() if k != "t"} for r in recs]  # noqa: E731
    j_recs, t_recs = drop(j.ledger.tracker.mems), drop(t.ledger.tracker.mems)
    assert t_recs == j_recs
    ops = {r["op"] for r in t_recs}
    assert {"adopt_prefix", "retain_cached"} <= ops


def _recording(sched):
    """The logits row of every sampled position, by (rid, position)."""
    rows, sample = {}, sched._sample_one

    def record(req, row):
        rows[req.rid, len(req.output)] = np.array(row)
        return sample(req, row)

    sched._sample_one = record
    return rows


def _plant(sched, fault):
    """A copy-on-write adoption whose tail block is left unwritten, or
    filled from the first shared block instead of the matched one."""
    pool, t = sched.pool, BLOCK
    adopt = pool.adopt_prefix

    def faulty(rid, shared, tail_block, n_tokens):
        adopt(rid, shared, tail_block, n_tokens)
        if tail_block is None:
            return
        dst = pool.blocks_of(rid)[-1]
        for buf in (pool.k, pool.v):
            if fault == "cow_copy_skipped":
                buf[:, dst * t : (dst + 1) * t].zero_()
            else:
                buf[:, dst * t : (dst + 1) * t] = buf[:, shared[0] * t : (shared[0] + 1) * t]

    pool.adopt_prefix = faulty


@pytest.mark.parametrize("fault", [None, "cow_copy_skipped", "cow_copy_from_wrong_block"],
                         ids=["honest", "cow_copy_skipped", "cow_copy_from_wrong_block"])
def test_warm_logits_match_cold_and_a_planted_fault_shows(weights, fault):
    """Cached serving's logits at every sampled position are cold
    serving's within the parity tolerance (rtol 1e-4, atol 1e-5); with a
    planted copy-on-write fault the same comparison fails, so it can see
    a wrong cache and not only a flipped token."""
    cfg = weights[PORT][0]
    waves = _waves(cfg.vocab)
    cold = _sched(PORT, weights, cached=False)
    cold_rows = _recording(cold)
    _serve_waves(cold, waves)
    warm = _sched(PORT, weights)
    warm_rows = _recording(warm)
    if fault is not None:
        _plant(warm, fault)
    _serve_waves(warm, waves)
    assert warm.pool.cow_copies == 2 and warm_rows.keys() == cold_rows.keys()
    close = [np.allclose(warm_rows[key], cold_rows[key], rtol=1e-4, atol=1e-5)
             for key in cold_rows]
    if fault is None:
        assert all(close)
    else:
        assert not all(close)


def test_eviction_under_admission_pressure(weights):
    """A pool too small to keep every finished prompt cached evicts LRU
    prefixes to admit new work, and serves what cold serving serves."""
    cfg = weights[PORT][0]
    rng = np.random.default_rng(10)
    waves = [[_prompt(rng, 8, cfg.vocab)] for _ in range(6)]
    warm = _sched(PORT, weights, slots=2, n_blocks=9)
    outs = _serve_waves(warm, waves)
    assert sorted(outs) == list(range(6))
    assert warm.prefix_cache.evicted_blocks > 0
    assert outs == _serve_waves(_sched(PORT, weights, cached=False, slots=2, n_blocks=9), waves)
    ref = _sched(REF, weights, slots=2, n_blocks=9)
    assert _serve_waves(ref, waves) == outs
    assert ref.prefix_cache.evicted_blocks == warm.prefix_cache.evicted_blocks


def test_shared_blocks_counted_once_in_utilization(weights):
    """Co-resident requests aliasing one prefix contribute its physical
    rows (and tokens) once."""
    cfg = weights[PORT][0]
    rng = np.random.default_rng(11)
    base = _prompt(rng, 8, cfg.vocab)
    exts = [np.concatenate([base, _prompt(rng, 4, cfg.vocab)]) for _ in range(2)]
    sched = _sched(PORT, weights)
    _serve_waves(sched, [[base]])
    for p in exts:
        sched.submit(p, GEN)
    while sched.queue or any(r is not None for r in sched.active):
        sched.round()
        sched.pool.validate()
        st = sched.pool.stats()
        assert st.utilization <= 1.0 + 1e-9
        assert st.held_blocks <= st.n_blocks
    assert sched.stats.shared_blocks_peak >= 2


def test_followup_adopts_generated_tokens(weights):
    """A finished request re-commits prompt + generated tokens, so a
    follow-up turn matches into the generated region."""
    cfg = weights[PORT][0]
    rng = np.random.default_rng(13)
    base = _prompt(rng, 10, cfg.vocab)
    warm = _sched(PORT, weights)
    reply = _serve_waves(warm, [[base]])[0]
    followup = np.concatenate([base, np.asarray(reply, np.int32), _prompt(rng, 5, cfg.vocab)])
    # 10 prompt + 3 generated committed (the last sampled token has no KV
    # row): 3 full blocks, 2 of whose tokens were generated
    assert warm.prefix_cache.match_tokens(followup) == 12
    outs = _serve_waves(warm, [[followup]])
    cold = _serve_waves(_sched(PORT, weights, cached=False), [[base], [followup]])
    assert outs == cold
    assert warm.stats.prefix_hit_tokens == 12
    assert warm.stats.prefill_tokens == 10 + (len(followup) - 12)


def test_followup_on_decode_made_rows_is_uncached_serving(weights):
    """A follow-up turn (prompt + output + fresh tokens) adopts K/V rows
    that decode steps wrote; in f32 on the CPU its streams are the
    uncached run's and the reference's cached run's, and its logits at
    every sampled position the uncached run's within the parity tolerance
    (the on-card counterpart is chip_smoke's follow-up turn)."""
    cfg = weights[PORT][0]
    rng = np.random.default_rng(19)
    first = [_prompt(rng, n, cfg.vocab) for n in (9, 14)]
    extra = [_prompt(rng, 6, cfg.vocab) for _ in first]
    runs = {}
    for side, cached in ((PORT, True), (PORT, False), (REF, True)):
        sched = _sched(side, weights, cached=cached)
        replies = _serve_waves(sched, [first], gen=6)
        follow = [np.concatenate([p, np.asarray(replies[i], np.int32), extra[i]])
                  for i, p in enumerate(first)]
        rows = _recording(sched) if side is PORT else None
        hits = sched.stats.prefix_hit_tokens
        outs = _serve_waves(sched, [follow], gen=6)
        runs[side is PORT, cached] = (outs, rows, sched.stats.prefix_hit_tokens - hits)
    (warm, warm_rows, warm_hits), (cold, cold_rows, cold_hits) = (
        runs[True, True], runs[True, False])
    ref_outs, _, ref_hits = runs[False, True]
    assert warm == cold == ref_outs
    # each follow-up adopts its transcript's full blocks (prompt + 5 of its
    # 6 tokens committed: 14 and 19 tokens, 3 and 4 blocks), reaching past
    # its prompt into rows that decode wrote
    assert (warm_hits, cold_hits, ref_hits) == (12 + 16, 0, 12 + 16)
    assert warm_rows.keys() == cold_rows.keys() and len(warm_rows) == 2 * 6
    for key, row in cold_rows.items():
        np.testing.assert_allclose(warm_rows[key], row, rtol=1e-4, atol=1e-5)


def test_copy_on_write_is_in_place():
    """The copy-on-write copy writes inside ``pool.k`` and ``pool.v``,
    which stay the same tensors at the same addresses (a captured graph
    binds them): the new block holds the source block's rows."""
    cfg = t_smoke("smollm_360m")
    pool = TPool(cfg, n_blocks=9, block_tokens=BLOCK, device="cpu")
    cache = TCache(pool)
    k, v, ptrs = pool.k, pool.v, (pool.k.data_ptr(), pool.v.data_ptr())
    g = torch.Generator().manual_seed(0)
    pool.k.copy_(torch.randn(pool.k.shape, generator=g))
    pool.v.copy_(torch.randn(pool.v.shape, generator=g))
    prompt = np.arange(10, dtype=np.int32)
    pool.admit(0, 12)
    pool.note_tokens(0, 10)
    cache.commit(prompt, pool.blocks_of(0))
    pool.release(0)
    match = cache.lookup(np.concatenate([prompt[:6], [99, 98]]).astype(np.int32))
    assert (match.matched, match.tail_block is not None) == (6, True)
    pool.admit(1, 12)
    pool.adopt_prefix(1, match.shared, match.tail_block, match.matched)
    assert pool.cow_copies == 1
    assert pool.k is k and pool.v is v
    assert (pool.k.data_ptr(), pool.v.data_ptr()) == ptrs
    src, dst = match.tail_block, pool.blocks_of(1)[-1]
    assert src != dst
    for t in (pool.k, pool.v):
        assert torch.equal(t[:, dst * BLOCK : (dst + 1) * BLOCK],
                           t[:, src * BLOCK : (src + 1) * BLOCK])
    pool.validate()


def test_scheduler_checks_the_cache():
    """A cache must index the scheduler's own pool."""
    cfg = t_smoke("smollm_360m")
    params = tlm.init_params(cfg, 0, device="cpu")
    pool = _pool(PORT, cfg)
    other = TCache(_pool(PORT, cfg))
    with pytest.raises(ValueError, match="must index this pool"):
        TSched(cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, prefix_cache=other)
