"""Port parity for the vlm family (internvl2-76b's backbone) against the
reference (``repro``), on the reference's own weights (``interop``), at
the smoke config in float32: the config, registry and parameter tree,
``modality_batch_leaves``, the full-sequence forward with patch
embeddings ahead of the tokens (``trunk``, ``forward``, ``prefill``,
``make_prefill_step``), the pool engine's and the fixed engine's token
streams (greedy and seeded, w_bits 0 and 2), n-gram and packed-twin
speculation on a vlm target, budgeted decode, and the seeded weights'
bytes. Float outputs are held at 1e-4 relative, 1e-5 absolute; token
streams and counters exactly. The reference's forward runs the jnp
attention, no Pallas kernel, so it runs as it is."""

import dataclasses
import functools
import hashlib
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconf  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import modality_batch_leaves as j_leaves  # noqa: E402
from repro.runtime import speculative as jspec  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.prefix_cache import PrefixCache as JCache  # noqa: E402
from repro.runtime.residency import plan as jplan  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch import configs as tconf  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import (  # noqa: E402
    ATTN_SERVED_FAMILIES,
    POOL_FAMILIES,
    TRAIN_FAMILIES,
)
from repro_torch.models.config import modality_batch_leaves as t_leaves  # noqa: E402
from repro_torch.runtime import speculative as tspec  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache as TCache  # noqa: E402
from repro_torch.runtime.residency import executor as texec  # noqa: E402
from repro_torch.runtime.residency import plan as tplan  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCH = "internvl2_76b"
B, S = 2, 9
SLOTS, MAX_LEN, BLOCK, CHUNK = 3, 40, 4, 12
PROMPT_LENS = (5, 17, 9, 3, 21)  # 17 and 21 prefill in chunks across rounds
GEN = (6, 4, 8, 5, 7)
COUNTERS = ("completed", "generated_tokens", "prefill_steps", "prefill_tokens",
            "decode_steps", "rounds")
SAMPLING = [dict(), dict(temperature=0.9, top_k=20, seed=7)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _weights(bits):
    """Both packages' smoke configs at ``bits`` and the reference's weights,
    carried into the port byte for byte."""
    jc = dataclasses.replace(jconf.get_smoke_config(ARCH), w_bits=bits)
    tc = dataclasses.replace(tconf.get_smoke_config(ARCH), w_bits=bits)
    jp = jlm.init_params(jc, jax.random.key(0))
    return jc, tc, jp, params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return toks, patches


# ---------------- config, weights ----------------


def test_config_and_registry_match_reference():
    for name in (ARCH, "internvl2-76b"):
        assert tconf.canonical(name) == jconf.canonical(name) == ARCH
        assert dataclasses.asdict(tconf.get_config(name)) == dataclasses.asdict(
            jconf.get_config(name))
        assert dataclasses.asdict(tconf.get_smoke_config(name)) == dataclasses.asdict(
            jconf.get_smoke_config(name))
    full = tconf.get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads, full.n_kv, full.hd,
            full.d_ff, full.vocab, full.n_patches) == (
        "vlm", 80, 8192, 64, 8, 128, 28672, 128256, 256)
    # the pool engine, the attention-KV entry points and training take it
    assert "vlm" in POOL_FAMILIES and "vlm" in ATTN_SERVED_FAMILIES
    assert "vlm" in TRAIN_FAMILIES and texec.supports_budgeted_decode(full)


@pytest.mark.parametrize("arch", jconf.ARCH_IDS)
def test_modality_batch_leaves_match_reference(arch):
    for get in ((jconf.get_config, tconf.get_config),
                (jconf.get_smoke_config, tconf.get_smoke_config)):
        assert t_leaves(get[1](arch)) == j_leaves(get[0](arch))
    assert t_leaves(tconf.get_config(ARCH)) == {"prefix_embeds": (256, 8192)}


@pytest.mark.parametrize("bits", [0, 2])
def test_init_params_has_the_reference_s_tree(bits):
    jc = dataclasses.replace(jconf.get_smoke_config(ARCH), dtype="bfloat16", w_bits=bits)
    tc = dataclasses.replace(tconf.get_smoke_config(ARCH), dtype="bfloat16", w_bits=bits)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jlm.abstract_params(jc))

    def spec(tree):
        return {k: spec(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tree.items()}

    assert spec(tlm.init_params(tc, 0, device="cpu").tree()) == want


def _digest(tree, h=None, path=""):
    h = h or hashlib.sha256()
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            _digest(leaf, h, f"{path}{name}/")
            continue
        t = leaf.detach().contiguous()
        h.update(f"{path}{name}:{t.dtype}:{tuple(t.shape)}".encode())
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.uint8)
        h.update(bits.numpy().tobytes())
    return h.hexdigest()


# sha256 of init_params(smoke config, seed 0) on the CPU, recorded when the
# vlm family was ported (it draws as the dense family does)
SEEDED = {
    0: "3c481f929f7fedbe1fdcb4960afc6c662cc28d2753637411e73c75592eb95005",
    2: "1ddf15dbd47a80e2c10a418f6b47ff4de8ecb13893241e7b02bbf17c13ffc35a",
}


@pytest.mark.parametrize("bits", sorted(SEEDED))
def test_seeded_init_params_keep_their_bytes(bits):
    cfg = dataclasses.replace(tconf.get_smoke_config(ARCH), w_bits=bits)
    assert _digest(tlm.init_params(cfg, 0, device="cpu").tree()) == SEEDED[bits]


# ---------------- the forward with patch embeddings ----------------


@pytest.mark.parametrize("bits", [0, 2])
def test_forward_with_prefix_embeds_matches_reference(bits):
    """``trunk`` (the token positions only), ``forward``, ``prefill`` and
    ``make_prefill_step`` with 16 patch embeddings ahead of 9 tokens, and
    the text-only forward, against the reference's."""
    jc, tc, jp, tp = _weights(bits)
    toks, patches = _batch(tc)
    tt, tpe = torch.from_numpy(toks), torch.from_numpy(patches)
    jt, jpe = jnp.asarray(toks), jnp.asarray(patches)
    x_t, aux_t = tlm.trunk(tp, tc, tt, prefix_embeds=tpe)
    x_j, _ = jlm.trunk(jp, jc, jt, prefix_embeds=jpe)
    assert x_t.shape == (B, S, tc.d_model) and float(aux_t) == 0.0
    _close(x_t, x_j)
    lg_t, _ = tlm.forward(tp, tc, tt, prefix_embeds=tpe)
    lg_j, _ = jlm.forward(jp, jc, jt, prefix_embeds=jpe)
    _close(lg_t, lg_j)
    _close(tlm.prefill(tp, tc, tt, prefix_embeds=tpe), jlm.prefill(jp, jc, jt, prefix_embeds=jpe))
    # the patches move the logits: a text-only forward is another function
    text_t, _ = tlm.forward(tp, tc, tt)
    _close(text_t, jlm.forward(jp, jc, jt)[0])
    assert not torch.allclose(text_t, lg_t, rtol=RTOL, atol=ATOL)
    want = jax.jit(jsteps.make_prefill_step(jc))(
        jp, {"tokens": jt, "labels": jt, "prefix_embeds": jpe})
    got = tsteps.make_prefill_step(tc)(tp, {"tokens": tt, "labels": tt, "prefix_embeds": tpe})
    assert got.shape == (B, 1, tc.padded_vocab)
    _close(got, want)


# ---------------- serving: the pool engine, the fixed engine ----------------


def _trace(cfg):
    rng = np.random.default_rng(42)
    return [rng.integers(0, cfg.vocab, size=p).astype(np.int32) for p in PROMPT_LENS]


def _serve(sched_cls, pool, cfg, params, sampling, cache_cls=None, **kw):
    if cache_cls is not None:
        kw["prefix_cache"] = cache_cls(pool)
    sched = sched_cls(cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                      sampling=sampling, **kw)
    for prompt, gen in zip(_trace(cfg), GEN):
        sched.submit(prompt, gen)
    stats = sched.run()
    return sched.outputs(), stats


@pytest.mark.parametrize("sampling", SAMPLING, ids=["greedy", "seeded"])
@pytest.mark.parametrize("bits", [0, 2])
def test_pool_engine_streams_match_reference(bits, sampling):
    """The continuous-batching scheduler over the KV pool, text tokens as
    the reference serves a vlm arch (prefix cache on): identical streams
    and counters."""
    jc, tc, jp, tp = _weights(bits)
    j_out, j_stats = _serve(JSched, JPool.for_slots(jc, slots=SLOTS, max_len=MAX_LEN,
                                                    block_tokens=BLOCK),
                            jc, jp, jlm.SamplingParams(**sampling), JCache)
    t_out, t_stats = _serve(TSched, TPool.for_slots(tc, slots=SLOTS, max_len=MAX_LEN,
                                                    block_tokens=BLOCK, device="cpu"),
                            tc, tp, tlm.SamplingParams(**sampling), TCache)
    assert t_out == j_out
    assert [len(t_out[r]) for r in sorted(t_out)] == list(GEN)
    for name in COUNTERS:
        assert getattr(t_stats, name) == getattr(j_stats, name), name
    assert t_stats.prefill_steps > len(PROMPT_LENS)  # chunked prefill ran


FIXED = ["--requests", "5", "--batch", "2", "--prompt-len", "6", "--gen-len", "5",
         "--max-len", "16", "--seed", "3"]


@pytest.mark.parametrize("bits", [0, 2])
def test_fixed_engine_streams_match_reference(bits):
    """The fixed-batch loop (``lm.decode_step`` over ``lm.init_cache``) on
    both packages: identical streams and step counts."""
    jc, tc, jp, tp = _weights(bits)
    want = jserve.run_fixed_engine(jc, jp, jserve.build_parser().parse_args(FIXED))
    got = serve.run_fixed_engine(tc, tp, serve.build_parser().parse_args(FIXED), "cpu")
    assert got["outputs"] == want["outputs"]
    for key in ("engine", "requests", "generated_tokens", "steps", "decode_steps"):
        assert got[key] == want[key], key


def test_fixed_decode_step_matches_reference():
    """12 steps of ``make_serve_step`` over ``init_cache`` (the fixed
    engine's decode), logits and cache leaves, at w_bits 2."""
    jc, tc, jp, tp = _weights(2)
    jstep, tstep = jax.jit(jsteps.make_serve_step(jc)), tsteps.make_serve_step(tc)
    jcache, tcache = jlm.init_cache(jc, B, 16), tlm.init_cache(tc, B, 16, device="cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab, (12, B, 1)).astype(np.int32)
    for tok in toks:
        lg_j, jcache = jstep(jp, jnp.asarray(tok), jcache)
        lg_t, tcache = tstep(tp, torch.from_numpy(tok).long(), tcache)
        _close(lg_t, lg_j)
    for key in ("k", "v", "len"):
        _close(tcache[key], jcache[key])


# ---------------- speculation, budgeted decode ----------------


def _spec_pool(pool_cls, cfg, **kw):
    return pool_cls(cfg, n_blocks=1 + SLOTS * MAX_LEN // BLOCK, block_tokens=BLOCK, **kw)


@pytest.mark.parametrize("drafter", ["ngram", ARCH])
def test_speculation_on_a_vlm_target_matches_reference(drafter):
    """n-gram and packed-twin drafters (the twin of a dequantized target,
    re-packed at 2 bits) on a vlm target: streams equal to plain decode's
    and the reference's, counters the reference's."""
    jc, tc, jp, tp = _weights(0)
    if drafter == ARCH:
        jp, tp = jspec.dequantize_ffn_params(jp, 2), tspec.dequantize_ffn_params(tp, 2)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, jc.vocab, size=(6,)).astype(np.int32) for _ in range(3)]
    sp = dict(temperature=0.9, top_k=32, seed=3)

    def run(sched_cls, pool, cfg, params, sampling, spec=None):
        sched = sched_cls(cfg, params, pool, slots=SLOTS - 1, max_len=MAX_LEN,
                          sampling=sampling, speculative=spec)
        for p in prompts:
            sched.submit(p, 8)
        sched.run()
        return sched

    plain = run(TSched, _spec_pool(TPool, tc, device="cpu"), tc, tp,
                tlm.SamplingParams(**sp)).outputs()
    tsp = tspec.build_speculator(tc, tp, tspec.SpecConfig(drafter, depth=4, quant=2),
                                 slots=SLOTS - 1, max_len=MAX_LEN, smoke=True)
    jsp = jspec.build_speculator(jc, jp, jspec.SpecConfig(drafter, depth=4, quant=2),
                                 slots=SLOTS - 1, max_len=MAX_LEN, smoke=True)
    got = run(TSched, _spec_pool(TPool, tc, device="cpu"), tc, tp,
              tlm.SamplingParams(**sp), tsp)
    want = run(JSched, _spec_pool(JPool, jc), jc, jp, jlm.SamplingParams(**sp), jsp)
    assert got.outputs() == plain == want.outputs()
    assert tsp.is_model == (drafter == ARCH)
    for name in ("accepted_tokens", "draft_tokens", "verify_steps"):
        assert getattr(got.stats, name) == getattr(want.stats, name), name


@pytest.mark.parametrize("bits", [0, 2])
def test_budgeted_decode_matches_reference(bits):
    """Half the plan's FFN tile bytes resident: one layer streams through
    ``stream_matmul``'s plain version; the streams equal the unbudgeted
    run's and the reference's budgeted run's."""
    jc, tc, jp, tp = _weights(bits)
    half = sum(b.padded_bytes() for b in tplan.weight_blocks(tc)) // 2
    tplan_ = tplan.compile_residency_plan(tc, vmem_budget_bytes=half)
    jplan_ = jplan.compile_residency_plan(
        jc, vmem_budget_bytes=half,
        traffic=jplan.TrafficProfile(lanes=SLOTS, prompt_len=max(PROMPT_LENS), gen_len=max(GEN)))
    assert tplan_.layer_stream_mask(tc) == (False, True)

    def tpool():
        return TPool.for_slots(tc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK,
                               device="cpu")

    sp = dict(temperature=0.9, top_k=20, seed=7)
    budgeted, _ = _serve(TSched, tpool(), tc, tp, tlm.SamplingParams(**sp), residency=tplan_)
    plain, _ = _serve(TSched, tpool(), tc, tp, tlm.SamplingParams(**sp))
    want, _ = _serve(JSched, JPool.for_slots(jc, slots=SLOTS, max_len=MAX_LEN,
                                             block_tokens=BLOCK),
                     jc, jp, jlm.SamplingParams(**sp), residency=jplan_)
    assert budgeted == plain == want


# ---------------- the serve entry point ----------------


def _metrics(out):
    return json.loads(next(l for l in out.splitlines() if l.startswith("[serve/metrics] "))
                      .split(" ", 1)[1])


@pytest.mark.parametrize("engine", ["pool", "fixed"])
def test_serve_cli_serves_internvl(engine, capsys):
    """``serve --arch internvl2-76b`` serves its smoke config on the CPU
    through either engine, packed at 2 bits."""
    argv = ["--arch", "internvl2-76b", "--smoke", "--device", "cpu", "--quant", "2",
            "--engine", engine, *FIXED]
    assert serve.main(argv) == 0
    m = _metrics(capsys.readouterr().out)
    assert m["engine"] == engine and m["generated_tokens"] == 25
    assert len(m["outputs"]) == 5
