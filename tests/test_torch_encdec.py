"""Port parity for the enc-dec family (whisper-tiny) against the reference
(``repro``), on the reference's own weights (``interop``), at the smoke
config in float32: the config and registry, the parameter tree,
``encode``, ``trunk``, ``forward``, ``init_decode_state``'s leaves and
greedy ``decode_step`` streams (w_bits 0 and 2, 32 frames and a ragged
30), the step builders, interop and checkpoints both ways, the seeded
weights' bytes, and the refusals of the paths the family does not take.
Float outputs are held at 1e-4 relative, 1e-5 absolute; token streams,
shapes, dtypes and exit codes exactly. The reference's ``encdec`` runs the
jnp attention, no Pallas kernel, so it runs as it is."""

import dataclasses
import functools
import hashlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconf  # noqa: E402
from repro.ckpt import CheckpointManager as JCkpt  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs as tconf  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    params_from_checkpoint,
    params_from_reference,
    params_to_reference,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec as tenc  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import (  # noqa: E402
    ATTN_SERVED_FAMILIES,
    PORTED_FAMILIES,
    POOL_FAMILIES,
)
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.residency.executor import supports_budgeted_decode  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCH = "whisper_tiny"
B, S, MAX_LEN, STEPS = 2, 7, 24, 18
FRAMES = (32, 30)  # the smoke config's frontend_len, and a ragged count


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
    tree = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, tree, params_from_reference(tree, tc, device="cpu")


def _inputs(vocab, d, frames, seed=0):
    rng = np.random.default_rng(seed)
    fr = rng.normal(size=(B, frames, d)).astype(np.float32)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return fr, toks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------- config, weights ----------------


def test_config_and_registry_match_reference():
    for name in (ARCH, "whisper-tiny"):
        assert tconf.canonical(name) == jconf.canonical(name) == ARCH
        assert dataclasses.asdict(tconf.get_config(name)) == dataclasses.asdict(
            jconf.get_config(name))
        assert dataclasses.asdict(tconf.get_smoke_config(name)) == dataclasses.asdict(
            jconf.get_smoke_config(name))
    full = tconf.get_config(ARCH)
    assert (full.family, full.n_layers, full.n_enc_layers, full.d_model, full.n_heads,
            full.hd, full.frontend_len) == ("encdec", 4, 4, 384, 6, 64, 1500)
    assert ARCH in tconf.ARCH_IDS and "encdec" in PORTED_FAMILIES
    # neither the pool engine nor the attention-KV entry points take it
    assert "encdec" not in POOL_FAMILIES and "encdec" not in ATTN_SERVED_FAMILIES


@pytest.mark.parametrize("bits", [0, 2])
def test_init_params_has_the_reference_s_tree(bits):
    """Decoder ``layers`` (self- and ``x_`` cross-attention, ``ln_x``),
    ``enc_layers`` and ``enc_final_norm``, each leaf's shape and dtype in
    bf16 (the f32 leaves stay f32), both FFN stacks packed at w_bits 2."""
    jc = dataclasses.replace(jconf.get_smoke_config(ARCH), dtype="bfloat16", w_bits=bits)
    tc = dataclasses.replace(tconf.get_smoke_config(ARCH), dtype="bfloat16", w_bits=bits)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jlm.abstract_params(jc))
    got = tlm.init_params(tc, 0, device="cpu")

    def spec(tree):
        return {k: spec(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tree.items()}

    assert spec(got.tree()) == want
    assert got.enc_layer(1)["wq"].shape == (tc.d_model, tc.n_heads * tc.hd)
    assert isinstance(got.enc_layer(0)["w1"], dict) == (bits == 2)


@pytest.mark.parametrize("bits", [0, 2])
def test_interop_carries_the_encdec_tree_both_ways(bits):
    """The reference's enc-dec tree into the port and back byte for byte;
    a bf16 copy keeps the f32 leaves f32; a tree packed unlike the config
    is refused, in the encoder's stack too."""
    _, tc, _, tree, tp = _weights(bits)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), params_to_reference(tp), tree)
    bf = params_from_reference(tree, tc, device="cpu", dtype=torch.bfloat16)
    assert bf["enc_final_norm"].dtype == torch.float32
    assert bf.layer(0)["ln_x"].dtype == torch.float32
    assert bf.layer(0)["x_wq"].dtype == bf.enc_layer(0)["wq"].dtype == torch.bfloat16
    other = dataclasses.replace(tc, w_bits=2 - bits)
    with pytest.raises(ValueError, match="layers/w1"):
        params_from_reference(tree, other, device="cpu")
    mixed = dict(tree, enc_layers=_weights(2 - bits)[3]["enc_layers"])
    with pytest.raises(ValueError, match="enc_layers/w1"):
        params_from_reference(mixed, tc, device="cpu")


def test_checkpoints_carry_the_encdec_tree_both_ways(tmp_path):
    """A reference checkpoint of the enc-dec weights read by the port, and
    the port's restored by the reference's manager, byte for byte."""
    _, tc, jp, tree, tp = _weights(2)
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


# sha256 of init_params(smoke config, seed 0) on the CPU, recorded when the
# enc-dec branch was written
SEEDED = {
    0: "78b0c277930bf78048b23ae5339ee9a1e4484c16a701f02894d2ea1a7f9b1e0c",
    2: "2e271292299591e6b24ff9800d377ea3dde04d6632748e4f768b26a198995c1e",
}


@pytest.mark.parametrize("bits", sorted(SEEDED))
def test_seeded_init_params_keep_their_bytes(bits):
    cfg = dataclasses.replace(tconf.get_smoke_config(ARCH), w_bits=bits)
    assert _digest(tlm.init_params(cfg, 0, device="cpu").tree()) == SEEDED[bits]


# ---------------- the forward ----------------


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("bits", [0, 2])
def test_encode_trunk_forward_match_reference(bits, frames):
    jc, tc, jp, _, tp = _weights(bits)
    fr, toks = _inputs(tc.vocab, tc.d_model, frames)
    _close(tenc.encode(tp, tc, torch.from_numpy(fr)), jenc.encode(jp, jc, jnp.asarray(fr)))
    x_t, aux_t = tenc.trunk(tp, tc, torch.from_numpy(toks), torch.from_numpy(fr))
    x_j, aux_j = jenc.trunk(jp, jc, jnp.asarray(toks), jnp.asarray(fr))
    _close(x_t, x_j)
    assert float(aux_t) == float(aux_j) == 0.0
    lg_t, _ = tenc.forward(tp, tc, torch.from_numpy(toks), torch.from_numpy(fr))
    lg_j, _ = jenc.forward(jp, jc, jnp.asarray(toks), jnp.asarray(fr))
    assert lg_t.shape == (B, S, tc.padded_vocab) and lg_t.dtype == torch.float32
    _close(lg_t, lg_j)


@pytest.mark.parametrize("bits", [0, 2])
def test_make_prefill_step_matches_reference(bits):
    """The step builder's enc-dec branch: ``encdec.trunk`` over the batch's
    ``frames``, the last position's logits."""
    jc, tc, jp, _, tp = _weights(bits)
    fr, toks = _inputs(tc.vocab, tc.d_model, FRAMES[1], seed=1)
    want = jax.jit(jsteps.make_prefill_step(jc))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    got = tsteps.make_prefill_step(tc)(
        tp, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
             "frames": torch.from_numpy(fr)})
    assert got.shape == (B, 1, tc.padded_vocab)
    _close(got, want)


# ---------------- decoding ----------------


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("bits", [0, 2])
def test_init_decode_state_leaves_match_reference(bits, frames):
    """``len``, the self-attention rings (zeros) and each layer's cross K/V
    (L, B, F, Hkv, D) against the reference's ``vmap``ped ones."""
    jc, tc, jp, _, tp = _weights(bits)
    fr, _ = _inputs(tc.vocab, tc.d_model, frames)
    want = jenc.init_decode_state(jp, jc, jnp.asarray(fr), MAX_LEN)
    got = tenc.init_decode_state(tp, tc, torch.from_numpy(fr), MAX_LEN)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype).removeprefix("torch.") == str(want[key].dtype), key
        _close(got[key], want[key])
    assert got["cross_k"].shape == (tc.n_layers, B, frames, tc.n_kv, tc.hd)


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("bits", [0, 2])
def test_decode_step_greedy_streams_match_reference(bits, frames):
    """STEPS greedy steps through ``make_serve_step`` on both sides, each
    fed its own argmax: identical tokens, the logits within tolerance, the
    port's cache the same tensors throughout (updated in place)."""
    jc, tc, jp, _, tp = _weights(bits)
    fr, _ = _inputs(tc.vocab, tc.d_model, frames, seed=2)
    jstep = jax.jit(jsteps.make_serve_step(jc))
    tstep = tsteps.make_serve_step(tc)
    jcache = jenc.init_decode_state(jp, jc, jnp.asarray(fr), MAX_LEN)
    tcache = tenc.init_decode_state(tp, tc, torch.from_numpy(fr), MAX_LEN)
    leaves = {k: v.data_ptr() for k, v in tcache.items()}
    jtok = np.zeros((B, 1), np.int32)
    ttok = torch.zeros((B, 1), dtype=torch.long)
    jstream, tstream = [], []
    for _ in range(STEPS):
        lg_j, jcache = jstep(jp, jnp.asarray(jtok), jcache)
        lg_t, tcache = tstep(tp, ttok, tcache)
        _close(lg_t, lg_j)
        jtok = np.asarray(lg_j)[:, :, : jc.vocab].argmax(-1).astype(np.int32)
        ttok = lg_t[:, :, : tc.vocab].argmax(-1)
        jstream.append(jtok[:, 0].tolist())
        tstream.append(ttok[:, 0].tolist())
    assert tstream == jstream
    assert int(tcache["len"]) == int(jcache["len"]) == STEPS
    for key in ("k", "v", "cross_k", "cross_v"):
        _close(tcache[key], jcache[key])
    assert {k: v.data_ptr() for k, v in tcache.items()} == leaves


def test_init_decode_state_refills_a_cache_in_place():
    """Given the cache of an earlier call, ``init_decode_state`` zeroes and
    refills the same tensors (what a captured step binds): the result is
    the fresh state's, bit for bit."""
    _, tc, _, _, tp = _weights(2)
    fr_a, _ = _inputs(tc.vocab, tc.d_model, FRAMES[0], seed=3)
    fr_b, _ = _inputs(tc.vocab, tc.d_model, FRAMES[0], seed=4)
    cache = tenc.init_decode_state(tp, tc, torch.from_numpy(fr_a), MAX_LEN)
    tenc.decode_step(tp, tc, torch.ones((B, 1), dtype=torch.long), cache)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    again = tenc.init_decode_state(tp, tc, torch.from_numpy(fr_b), MAX_LEN, cache=cache)
    fresh = tenc.init_decode_state(tp, tc, torch.from_numpy(fr_b), MAX_LEN)
    assert again is cache and {k: v.data_ptr() for k, v in again.items()} == ptrs
    for key in fresh:
        assert torch.equal(again[key], fresh[key]), key


# ---------------- what the family does not take ----------------


def test_the_dense_entry_points_refuse_encdec():
    """``lm.trunk``, ``lm.decode_step`` and ``lm.loss_fn`` never run the
    dense layer on a tree with cross-attention: they name ``encdec``'s;
    the training builders take the family through ``encdec.loss_fn``
    (their parity: ``tests/test_torch_train_families.py``); the pool and
    budgeted decode refuse it."""
    _, tc, _, _, tp = _weights(0)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="use encdec.trunk"):
        tlm.trunk(tp, tc, toks)
    with pytest.raises(ValueError, match="use encdec.trunk"):
        tlm.forward(tp, tc, toks)
    cache = tlm.init_cache(tc, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="use encdec.decode_step"):
        tlm.decode_step(tp, tc, toks[:, :1], cache)
    with pytest.raises(ValueError, match="use encdec.loss_fn"):
        tlm.loss_fn(tp, tc, toks, toks)
    assert callable(tsteps.make_loss_fn(tc)) and callable(tsteps.make_train_step(tc))
    with pytest.raises(ValueError, match="encdec"):
        TPool(tc, n_blocks=4, block_tokens=4, device="cpu")
    assert not supports_budgeted_decode(tc)
    dense = tconf.get_smoke_config("smollm_360m")
    with pytest.raises(ValueError, match="encdec.encode takes the enc-dec family"):
        tenc.encode(tlm.init_params(dense, 0, device="cpu"), dense, torch.zeros((1, 4, 128)))


def test_serve_cli_prints_the_reference_s_line_for_encdec(capsys):
    for argv in (["--arch", ARCH, "--device", "cpu"], ["--arch", "whisper-tiny", "--smoke"]):
        assert serve.main(argv) == 0
        assert capsys.readouterr().out == (
            "[serve] encdec serving is exercised in tests; use an LM arch\n")
