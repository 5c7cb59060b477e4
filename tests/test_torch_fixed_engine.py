"""Port parity for the fixed-batch engine and the SSM family (mamba2-1.3b)
against the reference (``repro``), on the reference's own weights
(``interop``), at the smoke configs in float32: ``init_cache``,
``cache_insert``, ``decode_step`` over the static per-slot cache (dense at
w_bits 0 and 2, a windowed ring that wraps, SSM, hybrid), decode against
the full-sequence forward, ``make_prefill_step``, ``run_fixed_engine``'s
token streams and ``serve.main``'s rules for the fixed engine; the MoE
family (olmoe) on it, through the capacity dispatch. Float outputs are
held at 1e-4 relative, 1e-5 absolute; token streams, shapes, dtypes and
exit codes exactly. The pool side (``KVPool``, ``Scheduler``, the
residency plan) still refuses the SSM family, and the seeded
``init_params`` of zamba2 and smollm keep their bytes."""

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
from repro.ckpt import CheckpointManager as JCkpt  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro_torch import configs as tconf  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    params_from_checkpoint,
    params_from_reference,
    params_to_reference,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.residency import compile_residency_plan  # noqa: E402
from repro_torch.runtime.residency.executor import supports_budgeted_decode  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCH = "mamba2_1p3b"
B, MAX_LEN, STEPS = 3, 16, 14
WINDOW = 8  # the windowed case's ring: W = 8 < MAX_LEN, so 14 steps wrap it

# (arch, w_bits, window override) of every decode_step case
CASES = {
    "smollm": ("smollm_360m", 0, None),
    "smollm_w2": ("smollm_360m", 2, None),
    "danube_ring": ("h2o_danube_1p8b", 0, WINDOW),
    "mamba2": (ARCH, 0, None),
    "zamba2": ("zamba2_2p7b", 0, None),
    "zamba2_w2": ("zamba2_2p7b", 2, None),
    "olmoe": ("olmoe_1b_7b", 0, None),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _weights(case):
    """Both packages' configs and the reference's weights, carried into the
    port byte for byte."""
    arch, bits, window = CASES[case]
    over = dict(w_bits=bits, **({"sliding_window": window} if window else {}))
    jc = dataclasses.replace(jconf.get_smoke_config(arch), **over)
    tc = dataclasses.replace(tconf.get_smoke_config(arch), **over)
    jp = jlm.init_params(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, tree, params_from_reference(tree, tc, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------- config, weights ----------------


def test_config_and_registry_match_reference():
    for name in (ARCH, "mamba2-1.3b"):
        assert tconf.canonical(name) == jconf.canonical(name) == ARCH
        assert dataclasses.asdict(tconf.get_config(name)) == dataclasses.asdict(
            jconf.get_config(name))
        assert dataclasses.asdict(tconf.get_smoke_config(name)) == dataclasses.asdict(
            jconf.get_smoke_config(name))
    full = tconf.get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.d_inner, full.ssm_heads,
            full.ssm_state, full.n_kv_cache_layers) == ("ssm", 48, 2048, 4096, 64, 128, 0)
    assert tconf.ARCH_IDS[-1] == ARCH


def test_init_params_has_the_reference_s_tree():
    """``ln1`` and every Mamba2 leaf, with its shape and dtype, in bf16
    (the f32 leaves stay f32); no FFN and no shared block."""
    jc = dataclasses.replace(jconf.get_smoke_config(ARCH), dtype="bfloat16")
    tc = dataclasses.replace(tconf.get_smoke_config(ARCH), dtype="bfloat16")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jlm.abstract_params(jc))
    got = tlm.init_params(tc, 0, device="cpu").tree()

    def spec(tree):
        return {k: spec(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tree.items()}

    assert spec(got) == want
    assert "shared" not in got and "w1" not in got["layers"]


def test_interop_carries_the_ssm_tree_both_ways():
    """The reference's SSM tree into the port and back byte for byte; a
    bf16 copy keeps the f32 leaves f32."""
    _, tc, _, tree, tp = _weights("mamba2")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), params_to_reference(tp), tree)
    layers = params_from_reference(tree, tc, device="cpu", dtype=torch.bfloat16).tree()["layers"]
    for name in ("dt_bias", "a_log", "d_skip", "gate_norm", "ln1"):
        assert layers[name].dtype == torch.float32, name
    assert layers["in_x"].dtype == layers["out"].dtype == torch.bfloat16


def test_checkpoints_carry_the_ssm_tree_both_ways(tmp_path):
    """A reference checkpoint of the SSM weights read by the port, and the
    port's restored by the reference's manager, byte for byte."""
    _, tc, jp, tree, tp = _weights("mamba2")
    JCkpt(str(tmp_path / "ref")).save(1, (jp,))
    got = params_to_reference(params_from_checkpoint(str(tmp_path / "ref"), tc, "cpu"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), got, tree)
    CheckpointManager(str(tmp_path / "port")).save(1, (tp,))
    (back,), _ = JCkpt(str(tmp_path / "port")).restore((jax.tree.map(jnp.zeros_like, jp),))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), back, tree)


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


# sha256 of init_params(smoke config, seed 0) on the CPU, recorded before the
# SSM branch shared the hybrid's Mamba2 draw code
SEEDED = {
    ("zamba2_2p7b", 0): "a2b6a03a72429a009622feb34aec12e8551d44cab09ed8b2e778c997bae0596a",
    ("zamba2_2p7b", 2): "94410f102c99e46dc11925e33fb24fae86ddce76e20f10a024587e4abcbb1830",
    ("smollm_360m", 0): "e4d6be7979115dfa017992faf9d2fbf74b0c2f13a05177392886ce3c088cc3bf",
    ("smollm_360m", 2): "25137dca0b8c041e1c6d69df6fc6f14acbb94168ce5e0c6984255ce934839aeb",
}


@pytest.mark.parametrize("arch,bits", sorted(SEEDED))
def test_seeded_init_params_keep_their_bytes(arch, bits):
    cfg = dataclasses.replace(tconf.get_smoke_config(arch), w_bits=bits)
    assert _digest(tlm.init_params(cfg, 0, device="cpu").tree()) == SEEDED[arch, bits]


# ---------------- the cache ----------------


@pytest.mark.parametrize("arch", ["smollm_360m", "h2o_danube_1p8b", ARCH, "zamba2_2p7b",
                                  "olmoe_1b_7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(arch, dtype):
    """Every leaf of the reference's cache with its shape and dtype (the
    windowed ring's W, the SSD state in f32); ``len`` an int32 of one
    element at 0."""
    jc = dataclasses.replace(jconf.get_smoke_config(arch), dtype=dtype, sliding_window=0
                             if arch != "h2o_danube_1p8b" else WINDOW)
    tc = dataclasses.replace(tconf.get_smoke_config(arch), dtype=dtype,
                             sliding_window=jc.sliding_window)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jlm.init_cache(jc, B, MAX_LEN).items()}
    cache = tlm.init_cache(tc, B, MAX_LEN, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in cache.items()}
    assert got == want
    assert cache["len"].numel() == 1 and int(cache["len"]) == 0
    assert all(not bool(v.any()) for v in cache.values())


def test_zero_cache_resets_in_place():
    _, tc, _, _, tp = _weights("zamba2")
    cache = tlm.init_cache(tc, B, MAX_LEN, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    tlm.decode_step(tp, tc, torch.ones((B, 1), dtype=torch.long), cache)
    assert int(cache["len"]) == 1 and bool(cache["ssm"].any()) and bool(cache["k"].any())
    assert tlm.zero_cache(cache) is cache
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert all(not bool(v.any()) for v in cache.values())


@pytest.mark.parametrize("pos", [0, 5, MAX_LEN - 1, MAX_LEN + 3])
def test_cache_insert_matches_reference(pos):
    """The row lands at ``pos`` (clamped into the cache, as
    ``dynamic_update_slice`` clamps), in place, from an int or a device
    tensor."""
    rng = np.random.default_rng(pos)
    cache = rng.standard_normal((B, MAX_LEN, 2, 8)).astype(np.float32)
    new = rng.standard_normal((B, 1, 2, 8)).astype(np.float32)
    want = np.asarray(jattn.cache_insert(jnp.asarray(cache), jnp.asarray(new), pos))
    for p in (pos, torch.tensor([pos])):
        t = torch.from_numpy(cache.copy())
        out = tattn.cache_insert(t, torch.from_numpy(new), p)
        assert out is t
        np.testing.assert_array_equal(t.numpy(), want)


# ---------------- decode_step ----------------


@functools.lru_cache(maxsize=None)
def _ref_step(case):
    jc = _weights(case)[0]
    return jax.jit(lambda p, t, c: jlm.decode_step(p, jc, t, c))


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_reference(case):
    """STEPS steps of B lanes from one cache: the logits and every cache
    leaf (``len`` included) after each step; the port's cache is the same
    tensors throughout, updated in place."""
    jc, tc, jp, _, tp = _weights(case)
    step = _ref_step(case)
    jcache = jlm.init_cache(jc, B, MAX_LEN)
    cache = tlm.init_cache(tc, B, MAX_LEN, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, STEPS))
    for t in range(STEPS):
        jl, jcache = step(jp, jnp.asarray(toks[:, t:t + 1], jnp.int32), jcache)
        tl, out = tlm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]), cache)
        assert out is cache and tl.shape == (B, 1, tc.padded_vocab)
        _close(tl.numpy(), jl)
        assert set(cache) == set(jcache)
        for key, leaf in jcache.items():
            _close(cache[key].numpy(), leaf)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert int(cache["len"]) == STEPS
    if case == "danube_ring":  # the ring wrapped: every slot was rewritten
        assert cache["k"].shape[2] == WINDOW < STEPS


def test_decode_step_refuses_moe():
    """The refusal is lifted: the MoE decode step runs the capacity
    dispatch (``moe.moe_ffn``) over groups of one token, as the reference's
    does, and a group of one fits every expert's capacity, so each token
    keeps its whole top-k mix: the step's FFN is the dropless dispatch's on
    the same hidden state, and the step equals the reference's
    (``test_decode_step_matches_reference[olmoe]``)."""
    from repro_torch.models import moe as tmoe

    _, tc, _, _, tp = _weights("olmoe")
    lp = tp.layer(0)
    h = torch.from_numpy(np.random.default_rng(2).normal(size=(B, 1, tc.d_model))
                         .astype(np.float32))
    got, aux = tmoe.moe_ffn(h, lp["router"], lp["w1"], lp["w3"], lp["w2"], tc)
    want, _ = tmoe.moe_ffn_dropless(h, lp["router"], lp["w1"], lp["w3"], lp["w2"], tc)
    assert tmoe.moe_capacity(tc, 1) == 1 and aux.item() > 0
    _close(got.numpy(), want.numpy())
    cache = tlm.init_cache(tc, 1, 8, device="cpu")
    lg, _ = tlm.decode_step(tp, tc, torch.zeros((1, 1), dtype=torch.long), cache)
    assert lg.shape == (1, 1, tc.padded_vocab) and bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("arch", ["llama3p2_1b", "smollm_360m", ARCH])
def test_decode_matches_forward(arch):
    """The port's counterpart of the reference's ``test_decode_matches_forward``
    (tests/test_models.py): tokens fed one by one through ``decode_step``
    reproduce the port's teacher-forced ``forward`` logits (and ``prefill``'s),
    at the reference's tolerance, 2e-3."""
    cfg = tconf.get_smoke_config(arch)
    params = tlm.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 8)))
    full, aux = tlm.forward(params, cfg, toks)
    assert float(aux) == 0.0
    assert torch.equal(tlm.prefill(params, cfg, toks), full)
    cache = tlm.init_cache(cfg, 1, 8, device="cpu")
    dec = torch.cat([tlm.decode_step(params, cfg, toks[:, t:t + 1], cache)[0]
                     for t in range(8)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", ["smollm", "smollm_w2", "mamba2"])
def test_prefill_step_matches_reference(case):
    """``make_prefill_step``: the trunk's last position unembedded, (B, 1, V),
    against the reference's on the same batch; the port's ``prefill`` is
    its forward's logits at every position."""
    jc, tc, jp, _, tp = _weights(case)
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, 24))
    want = jax.jit(jsteps.make_prefill_step(jc))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.zeros((2, 24), jnp.int32)})
    got = tsteps.make_prefill_step(tc)(
        tp, {"tokens": torch.from_numpy(toks), "labels": torch.zeros((2, 24), dtype=torch.long)})
    assert got.shape == (2, 1, tc.padded_vocab)
    _close(got.numpy(), want)
    _close(tlm.prefill(tp, tc, torch.from_numpy(toks)).numpy(),
           jlm.prefill(jp, jc, jnp.asarray(toks, jnp.int32)))


def test_step_builders_refuse_the_unported_modalities():
    """Nothing is left to refuse: the prefill, serve and training builders
    take the vlm and enc-dec families (their branches: ``prefix_embeds``,
    ``encdec``); ``_split_batch`` hands the vlm's patch embeddings to the
    model, as the reference's does (training's parity:
    ``tests/test_torch_train_families.py``)."""
    for arch in ("internvl2_76b", "whisper_tiny"):
        tc = tconf.get_smoke_config(arch)
        for build in (tsteps.make_prefill_step, tsteps.make_serve_step, tsteps.make_loss_fn,
                      tsteps.make_train_step):
            assert callable(build(tc))
        batch = {"tokens": 1, "labels": 2, "prefix_embeds": 3, "frames": 4}
        want = jsteps._split_batch(jconf.get_smoke_config(arch), batch)
        assert tsteps._split_batch(tc, batch) == want
    assert tsteps._split_batch(tconf.get_smoke_config("smollm_360m"), batch) == (1, 2, {})


# ---------------- run_fixed_engine and serve.main ----------------

FIXED = ["--requests", "5", "--batch", "2", "--prompt-len", "6", "--gen-len", "5",
         "--max-len", "16", "--seed", "3"]


@pytest.mark.parametrize("case", ["smollm", "smollm_w2", "mamba2", "zamba2_w2", "olmoe"])
def test_run_fixed_engine_streams_match_reference(case):
    """5 requests on 2 lanes (5 % 2 != 0: the last wave runs one lane idle)
    through both packages' fixed loops on the same weights: identical token
    streams and step counts (each wave replays 6 prompt tokens after the
    reference's token-0 step, then generates 5)."""
    jc, tc, jp, _, tp = _weights(case)
    want = jserve.run_fixed_engine(jc, jp, jserve.build_parser().parse_args(FIXED))
    got = serve.run_fixed_engine(tc, tp, serve.build_parser().parse_args(FIXED), "cpu")
    assert got["outputs"] == want["outputs"]
    assert len(got["outputs"]) == 5 and all(len(v) == 5 for v in got["outputs"].values())
    for key in ("engine", "requests", "generated_tokens", "steps", "prefill_steps",
                "decode_steps"):
        assert got[key] == want[key], key
    assert got["steps"] == 3 * (1 + 6 + 4)
    assert not got["compiled"] and got["graphs"] == 0 and got["decode_step_ms_replay"] is None


def test_run_fixed_engine_has_no_cpu_graph():
    _, tc, _, _, tp = _weights("mamba2")
    with pytest.raises(ValueError, match="compiled steps are CUDA graphs; cpu has none"):
        serve.run_fixed_engine(tc, tp, serve.build_parser().parse_args(FIXED), "cpu",
                               compiled=True)


def _metrics(out):
    return json.loads(next(l for l in out.splitlines() if l.startswith("[serve/metrics] "))
                      .split(" ", 1)[1])


def test_serve_cli_serves_mamba2_on_the_fixed_engine(capsys):
    """``serve --arch mamba2_1p3b`` switches to the fixed engine with the
    reference's message; ``--quant`` prints its no-effect note; the
    streams are ``run_fixed_engine``'s."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--quant", "2", *FIXED]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert ("[serve] note: --quant has no effect on family 'ssm' (no dense FFN to pack)"
            in out)
    assert ("[serve] family 'ssm' keeps fixed-size per-slot decode state and holds no KV "
            "rows; using the fixed-batch engine" in out)
    assert "[serve/fixed] 5 requests, 25 generated tokens in 33 steps" in out
    m = _metrics(out)
    assert (m["engine"], m["prefill_steps"], m["completed"]) == ("fixed", 0, 5)
    assert m["kernel_launches"] == dict.fromkeys(m["kernel_launches"], 0)
    tc = tconf.get_smoke_config(ARCH)
    want = serve.run_fixed_engine(tc, tlm.init_params(tc, 3, device="cpu"),
                                  serve.build_parser().parse_args(FIXED), "cpu")
    assert {int(k): v for k, v in m["outputs"].items()} == want["outputs"]


def test_serve_cli_fixed_engine_on_a_dense_arch(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--quant", "2", "--engine", "fixed",
                       *FIXED]) == 0
    m = _metrics(capsys.readouterr().out)
    assert (m["engine"], m["generated_tokens"], m["cache_mib"] > 0) == ("fixed", 25, True)


@pytest.mark.parametrize("argv", [
    ["--arch", ARCH, "--vmem-budget", "1"],
    ["--arch", ARCH, "--speculate", "ngram"],
    ["--arch", "smollm_360m", "--engine", "fixed", "--vmem-budget", "1"],
    ["--arch", "zamba2_2p7b", "--engine", "fixed", "--speculate", "ngram"],
    ["--arch", ARCH, "--prompt-len", "12", "--gen-len", "8", "--max-len", "16"],
], ids=["ssm_budget", "ssm_speculate", "fixed_budget", "fixed_speculate", "past_max_len"])
def test_serve_cli_fixed_engine_refusals_are_the_reference_s(argv, capsys):
    """Exit 2 with the reference's lines, before any weight is drawn."""
    assert jserve.main(["--smoke", *argv]) == 2
    want = capsys.readouterr().out
    assert serve.main(["--smoke", "--device", "cpu", *argv]) == 2
    assert capsys.readouterr().out == want


def test_serve_cli_refuses_moe_on_the_fixed_engine(capsys):
    """The refusal is lifted: ``serve --engine fixed`` on olmoe serves
    through the capacity dispatch, and its streams are
    ``run_fixed_engine``'s on the seed's weights (which hold the
    reference's, ``test_run_fixed_engine_streams_match_reference``); no
    kernel is launched on the CPU."""
    assert serve.main(["--arch", "olmoe_1b_7b", "--smoke", "--device", "cpu", "--engine",
                       "fixed", *FIXED]) == 0
    m = _metrics(capsys.readouterr().out)
    assert (m["engine"], m["completed"], m["generated_tokens"]) == ("fixed", 5, 25)
    assert m["kernel_launches"] == dict.fromkeys(m["kernel_launches"], 0)
    tc = tconf.get_smoke_config("olmoe_1b_7b")
    want = serve.run_fixed_engine(tc, tlm.init_params(tc, 3, device="cpu"),
                                  serve.build_parser().parse_args(FIXED), "cpu")
    assert {int(k): v for k, v in m["outputs"].items()} == want["outputs"]


# ---------------- what still refuses the SSM family ----------------


def test_pool_side_refuses_ssm():
    """The pool, the scheduler and the residency plan take paged families
    only: the pool with the reference's message."""
    jc, tc = jconf.get_smoke_config(ARCH), tconf.get_smoke_config(ARCH)
    with pytest.raises(ValueError) as want:
        JPool(jc, n_blocks=4, block_tokens=4)
    with pytest.raises(ValueError) as got:
        TPool(tc, n_blocks=4, block_tokens=4, device="cpu")
    assert str(got.value) == str(want.value)
    pool = TPool(tconf.get_smoke_config("smollm_360m"), n_blocks=4, block_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="family 'ssm' is not ported to the pool engine"):
        Scheduler(tc, None, pool, slots=1, max_len=8)
    with pytest.raises(ValueError, match="ssm"):
        compile_residency_plan(tc, vmem_budget_bytes=0)
    assert not supports_budgeted_decode(tc)


def test_training_refuses_ssm():
    """The refusal is lifted: ``lm.loss_fn`` and ``make_loss_fn`` take the
    SSM family and agree with the reference's loss (its gradients:
    ``tests/test_torch_train_families.py``)."""
    jc, tc, jp, _, tp = _weights("mamba2")
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 12))
    labels = np.roll(toks, -1, axis=1)
    want, _ = jlm.loss_fn(jp, jc, jnp.asarray(toks, jnp.int32), jnp.asarray(labels, jnp.int32))
    got, (ce, aux) = tlm.loss_fn(tp, tc, torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert aux.item() == 0.0 and got.item() == ce.item()
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    assert tsteps.make_loss_fn(tc)(tp, batch).item() == got.item()
