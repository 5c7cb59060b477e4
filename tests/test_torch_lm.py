"""Port parity: the serving forward of ``repro_torch.models.lm`` against
``repro.models.lm`` on the reference's own weights (every ported arch's
SMOKE config, float32, and a head dim of 80), dense and with 1/2-bit
packed FFN carriers. h2o-danube's smoke config keeps a 64-token sliding
window, so its prompts, chunks and decode depths run past 64 tokens."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconf  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro_torch import configs as tconf  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ("smollm_360m", "llama3p2_1b", "h2o_danube_1p8b", "phi3_medium_14b")
MOE_ARCHS = ("olmoe_1b_7b", "moonshot_v1_16b_a3b")  # held in test_torch_moe.py
# the serving parity cases: every ported arch's smoke config, and
# h2o-danube's full config reduced with its own head dim of 80 (D 80 through
# RoPE and the plain attention)
CASES = ARCHS + ("h2o_danube_1p8b@d80",)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(w_bits, case="smollm_360m"):
    arch, _, variant = case.partition("@")
    if variant == "d80":
        jc = j_reduced(jconf.get_config(arch), head_dim=80)
        tc = t_reduced(tconf.get_config(arch), head_dim=80)
    else:
        jc, tc = j_smoke(arch), t_smoke(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    return dataclasses.replace(jc, w_bits=w_bits), dataclasses.replace(tc, w_bits=w_bits)


def _reference(case, fn, *args):
    """The reference's ``fn`` as the JAX package serves it (compiled), but
    op by op (``jax.disable_jit``) in the head-dim-80 case. Compiled there,
    XLA's CPU backend fuses RoPE and rounds its angles differently: at head
    dim 80 and position 75 its ``apply_rope`` is 1.3e-5 off its own op-by-op
    value, and a decode step's K row 2.45e-5 off a float64 evaluation of the
    same step, where the port and the op-by-op reference are 2.9e-6 and
    1.9e-6 off it."""
    if not case.endswith("@d80"):
        return fn(*args)
    with jax.disable_jit():
        return fn(*args)


def _past_window(cfg, n):
    """``n`` positions, moved past the sliding window where there is one."""
    return n + cfg.sliding_window


def _weights(w_bits, seed=0, case="smollm_360m"):
    jc, tc = _configs(w_bits, case)
    jp = jlm.init_params(jc, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, tree, params_from_reference(tree, tc, device="cpu")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL
    )


ALIASES = {"smollm_360m": "smollm-360m", "llama3p2_1b": "llama3.2-1b",
           "h2o_danube_1p8b": "h2o-danube-1.8b", "phi3_medium_14b": "phi3-medium-14b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_configs_match_reference(arch):
    for name in (arch, ALIASES[arch]):
        assert tconf.canonical(name) == jconf.canonical(name) == arch
        assert dataclasses.asdict(tconf.get_config(name)) == dataclasses.asdict(
            jconf.get_config(name))
        assert dataclasses.asdict(t_smoke(name)) == dataclasses.asdict(j_smoke(name))


def test_registry_is_the_reference_s_over_the_ported_archs():
    """``ARCH_IDS`` are the reference's archs, all ten, in its order, the
    aliases its aliases, and ``all_configs`` its configs over them; the
    last two ported (internvl2-76b and whisper-tiny) resolve by either id
    to the reference's full and smoke configs; an unknown arch raises,
    naming the archs."""
    assert tconf.ARCH_IDS == jconf.ARCH_IDS and len(tconf.ARCH_IDS) == 10
    assert tconf.ALIASES == jconf.ALIASES
    want = jconf.all_configs()
    got = tconf.all_configs()
    assert list(got) == tconf.ARCH_IDS
    for arch, cfg in got.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[arch])
    for name in ("internvl2-76b", "whisper_tiny"):
        assert tconf.canonical(name) == jconf.canonical(name)
        assert dataclasses.asdict(tconf.get_config(name)) == dataclasses.asdict(
            jconf.get_config(name))
        assert dataclasses.asdict(t_smoke(name)) == dataclasses.asdict(j_smoke(name))
    with pytest.raises(ValueError, match="ported archs: h2o_danube_1p8b, llama3p2_1b, "
                                         "phi3_medium_14b, smollm_360m, internvl2_76b, "
                                         "whisper_tiny, olmoe_1b_7b, moonshot_v1_16b_a3b, "
                                         "zamba2_2p7b, mamba2_1p3b"):
        tconf.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_head_dim_has_a_flash_kernel(arch):
    """The flash kernels take every registered arch's head dim (the CUDA
    wrapper refuses any other), full size and smoke."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    assert arch in tconf.ARCH_IDS
    assert tconf.get_config(arch).hd in HEAD_DIMS
    assert t_smoke(arch).hd in HEAD_DIMS


@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_params_from_reference_round_trips_bit_for_bit(w_bits):
    _, tc, _, tree, params = _weights(w_bits)
    back = params.tree()
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), back)
    )
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_got, flat_ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    if w_bits:
        assert isinstance(params.layer(0)["w1"], dict)
        assert params.layers.w1.packed.dtype == torch.uint8
        assert [n for n, _ in params.named_buffers()]  # carriers are buffers
        assert not any(p.requires_grad for p in params.parameters())


def test_params_from_reference_rejects_mismatched_quant():
    _, tc, _, tree, _ = _weights(2)
    with pytest.raises(ValueError):
        params_from_reference(tree, dataclasses.replace(tc, w_bits=0), "cpu")


def test_init_params_shapes_follow_reference():
    jc, tc = _configs(2)
    ref = jax.eval_shape(lambda k: jlm.init_params(jc, k), jax.random.key(0))
    got = tlm.init_params(tc, 0, device="cpu").tree()
    assert jax.tree.map(lambda s: (s.shape, str(s.dtype)), ref) == jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got
    )
    # one seed, the same numbers whichever device they are put on
    again = tlm.init_params(tc, 0, device="cpu").tree()
    assert torch.equal(got["embed"], again["embed"])


# smollm-360m at full size, seed 0, as ``init_params`` drew it when it drew
# each leaf whole: the first and last values of embed, wq and w1 and a
# blake2b digest of every leaf (names and bytes), dense and packed. Drawing
# a slice at a time must not move a bit.
SMOLLM_PINS = {
    0: dict(
        embed=([-0.0224609375, -0.0230712890625, -0.0050048828125, -0.0086669921875],
               [-0.0032806396484375, 0.0322265625, 0.0257568359375, -0.01422119140625]),
        wq=([0.01483154296875, -0.008056640625, -0.0177001953125, 0.0225830078125],
            [-0.041748046875, -0.00433349609375, 0.006439208984375, 0.0537109375]),
        w1=([-0.00921630859375, 0.017578125, 0.041259765625, 0.024658203125],
            [-0.0216064453125, -0.0118408203125, -0.0068359375, 0.01904296875]),
        digest="ded61a0cae7feb3280b6a25631bbe054",
    ),
    2: dict(
        w1_packed=([37, 69, 162, 166], [24, 70, 90, 134]),
        w1_scale=([0.037477556616067886, 0.0386904776096344],
                  [0.03920664265751839, 0.03768050670623779]),
        digest="9acf74d0ef32d872d9839e27b3001c5a",
    ),
}


def _digest(tree) -> str:
    import hashlib

    h = hashlib.blake2b(digest_size=16)

    def walk(node, prefix=""):
        for name in sorted(node):
            leaf = node[name]
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}/")
                continue
            h.update(f"{prefix}{name}".encode())
            view = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
            h.update(view.contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree)
    return h.hexdigest()


@pytest.mark.parametrize("w_bits", [0, 2])
def test_init_params_keeps_smollm_weights(w_bits):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("smollm_360m"), w_bits=w_bits)
    tree = tlm.init_params(cfg, 0, device="cpu").tree()
    pins = SMOLLM_PINS[w_bits]
    leaves = {"embed": tree["embed"], "wq": tree["layers"]["wq"], "w1": tree["layers"]["w1"]}
    if w_bits:
        leaves = {"w1_packed": tree["layers"]["w1"]["packed"],
                  "w1_scale": tree["layers"]["w1"]["scale"]}
    for name, (first, last) in ((k, v) for k, v in pins.items() if k != "digest"):
        flat = leaves[name].reshape(-1)
        assert flat[: len(first)].tolist() == first, name
        assert flat[-len(last):].tolist() == last, name
    assert _digest(tree) == pins["digest"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_bits", [1, 2])
def test_pack_ffn_params_is_the_packed_init(arch, w_bits):
    """Packing a dense draw's FFN leaves gives bitwise the packed draw, and
    shares every other leaf."""
    cfg = dataclasses.replace(t_smoke(arch), w_bits=0)
    dense = tlm.init_params(cfg, 3, device="cpu")
    got = tlm.pack_ffn_params(dense, w_bits).tree()
    want = tlm.init_params(dataclasses.replace(cfg, w_bits=w_bits), 3, device="cpu").tree()
    assert _digest(got) == _digest(want)
    assert got["layers"]["wq"].data_ptr() == dense.tree()["layers"]["wq"].data_ptr()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_prefill_with_cache_matches_reference(w_bits, case):
    jc, tc, jp, _, params = _weights(w_bits, case=case)
    rng = np.random.default_rng(w_bits)
    tokens = rng.integers(0, jc.vocab, size=(2, _past_window(jc, 12))).astype(np.int32)
    last = _past_window(jc, 9)
    lg, ks, vs = _reference(case, jlm.prefill_with_cache, jp, jc, jnp.asarray(tokens), last)
    tlg, tks, tvs = tlm.prefill_with_cache(params, tc, _t(tokens), last)
    assert tuple(tlg.shape) == (2, 1, tc.padded_vocab)
    _close(tlg, lg)
    _close(tks, ks)
    _close(tvs, vs)


def _pool(jc, rows, seed):
    rng = np.random.default_rng(seed)
    shape = (jc.n_layers, rows, jc.n_kv, jc.hd)
    return (
        rng.normal(size=shape).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
    )


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_decode_step_paged_matches_reference(w_bits, case):
    jc, tc, jp, _, params = _weights(w_bits, case=case)
    w = jc.sliding_window  # lanes 0 and 1 decode past the window
    pk, pv = _pool(jc, 40 + 2 * w, 10 + w_bits)
    # three lanes at different depths over private rows; row 0 is scratch
    row_table = np.zeros((3, 12 + w), np.int32)
    row_table[0, :8 + w] = np.arange(4, 12 + w)
    row_table[1, :12 + w] = np.arange(12 + w, 24 + 2 * w)
    row_table[2, :4] = np.arange(30 + 2 * w, 34 + 2 * w)
    lengths = np.array([5 + w, 11 + w, 0], np.int32)
    token = np.array([[3], [100], [511]], np.int32)
    lg, jk, jv = _reference(
        case, jlm.decode_step_paged, jp, jc, jnp.asarray(token), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(row_table), jnp.asarray(lengths),
    )
    tk, tv = _t(pk), _t(pv)
    tlg, tk2, tv2 = tlm.decode_step_paged(
        params, tc, _t(token), tk, tv, _t(row_table), _t(lengths)
    )
    assert tk2 is tk and tv2 is tv  # the pool is updated in place
    _close(tlg, lg)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_prefill_chunk_paged_matches_reference(w_bits, case):
    jc, tc, jp, _, params = _weights(w_bits, case=case)
    w = jc.sliding_window  # the chunk starts past the window
    pk, pv = _pool(jc, 32 + w, 20 + w_bits)
    c, start, n = 8, 6 + w, 5  # a 5-token final chunk after a (6 + w)-token prefix
    row_table = np.zeros((1, 16 + w), np.int32)
    row_table[0, :12 + w] = np.arange(4, 16 + w)
    write_rows = np.zeros((1, c), np.int32)  # padding -> scratch row 0
    write_rows[0, :n] = row_table[0, start : start + n]
    tokens = np.zeros((1, c), np.int32)
    tokens[0, :n] = np.random.default_rng(w_bits).integers(0, jc.vocab, n)
    lg, jk, jv = _reference(
        case, jlm.prefill_chunk_paged, jp, jc, jnp.asarray(tokens), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(row_table), jnp.asarray(write_rows),
        jnp.asarray(start, jnp.int32), jnp.asarray(n - 1, jnp.int32),
    )
    tk, tv = _t(pk), _t(pv)
    tlg, _, _ = tlm.prefill_chunk_paged(
        params, tc, _t(tokens), tk, tv, _t(row_table), _t(write_rows), start, n - 1
    )
    _close(tlg, lg)
    # the scratch rows take the padding's writes in an unspecified order
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])
    _close(tv[:, 1:], np.asarray(jv)[:, 1:])


@pytest.mark.parametrize("w_bits", [0, 2])
@pytest.mark.parametrize("start", [0, 3, 6])
def test_prefill_chunk_paged_device_start_is_the_int_call(w_bits, start):
    """``start`` as a one-element tensor (the captured chunk's input, the
    RoPE base and flash's device ``q_offset``) gives bitwise the int
    call's logits and pool rows, and agrees with the reference."""
    jc, tc, jp, _, params = _weights(w_bits)
    pk, pv = _pool(jc, 32, 30 + start)
    c, n = 8, 6
    row_table = np.zeros((1, 16), np.int32)
    row_table[0, :14] = np.arange(4, 18)
    write_rows = np.zeros((1, c), np.int32)
    write_rows[0, :n] = row_table[0, start : start + n]
    tokens = np.zeros((1, c), np.int32)
    tokens[0, :n] = np.random.default_rng(start).integers(0, jc.vocab, n)

    def run(first):
        tk, tv = _t(pk), _t(pv)
        lg, _, _ = tlm.prefill_chunk_paged(
            params, tc, _t(tokens), tk, tv, _t(row_table), _t(write_rows), first, n - 1
        )
        return lg, tk, tv

    got = run(torch.tensor([start]))
    want = run(start)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(run(torch.tensor(start)), want))
    lg, _, _ = jlm.prefill_chunk_paged(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(row_table), jnp.asarray(write_rows),
        jnp.asarray(start, jnp.int32), jnp.asarray(n - 1, jnp.int32),
    )
    _close(got[0], lg)


@pytest.mark.parametrize("w_bits", [0, 2])
@pytest.mark.parametrize("last", [0, 6, 11])
def test_prefill_with_cache_device_last_index_is_the_int_call(w_bits, last):
    """``last_idx`` as a one-element tensor (a bucket graph's input) gives
    bitwise the int call's logits and K/V rows, and agrees with the
    reference."""
    jc, tc, jp, _, params = _weights(w_bits)
    tokens = np.random.default_rng(last).integers(0, jc.vocab, size=(1, 12)).astype(np.int32)
    got = tlm.prefill_with_cache(params, tc, _t(tokens), torch.tensor([last]))
    want = tlm.prefill_with_cache(params, tc, _t(tokens), last)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    lg, _, _ = jlm.prefill_with_cache(jp, jc, jnp.asarray(tokens), last)
    _close(got[0], lg)


@pytest.mark.parametrize("q_offset", [0, 5, 17])
def test_flash_fwd_ref_takes_a_tensor_q_offset(q_offset):
    """The plain flash version with ``q_offset`` as a one-element int32
    tensor equals the int call, causal and windowed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_fwd_ref

    g = torch.Generator().manual_seed(q_offset)
    q = torch.randn((6, 9, 16), generator=g)
    k = torch.randn((2, 30, 16), generator=g)
    v = torch.randn((2, 30, 16), generator=g)
    for window in (0, 7):
        kw = dict(causal=True, window=window)
        want = flash_fwd_ref(q, k, v, q_offset=q_offset, **kw)
        dev = torch.tensor([q_offset], dtype=torch.int32)
        for got in (flash_fwd_ref(q, k, v, q_offset=dev, **kw),
                    fa.flash_fwd(q, k, v, q_offset=dev, **kw)):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="one int32"):
        fa.flash_fwd(q, k, v, q_offset=torch.tensor([q_offset]))


def test_tensor_q_offset_is_forward_only():
    """``ops.flash_attention`` takes a tensor ``q_offset`` without a
    gradient (no_grad, or inputs that need none) and refuses it where one
    would be needed, since ``flash_bwd`` takes an int; the int form is
    differentiable."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 5, 4, 8), generator=g)
    k = torch.randn((1, 12, 2, 8), generator=g)
    v = torch.randn((1, 12, 2, 8), generator=g)
    off = torch.tensor([7], dtype=torch.int32)
    want = ops.flash_attention(q, k, v, q_offset=7)
    assert torch.equal(ops.flash_attention(q, k, v, q_offset=off), want)
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(qg, k, v, q_offset=off), want)
    with pytest.raises(ValueError, match="forward-only"):
        ops.flash_attention(qg, k, v, q_offset=off)
    ops.flash_attention(qg, k, v, q_offset=7).sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())


def test_unported_family_raises():
    """Only the enc-dec family is refused by the full-sequence entry
    points: ``lm.trunk`` / ``lm.decode_step`` / ``lm.loss_fn`` on an
    enc-dec tree name ``encdec``'s. The MoE family's forward runs (the
    capacity dispatch, its aux loss > 0), and so do the vlm's and the MoE's
    losses (their parity: ``tests/test_torch_train_families.py``)."""
    moe = t_smoke("olmoe_1b_7b")
    params = tlm.init_params(moe, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    lg, aux = tlm.forward(params, moe, toks)
    assert lg.shape == (1, 4, moe.padded_vocab) and aux.item() > 0
    enc = t_smoke("whisper_tiny")
    enc_params = tlm.init_params(enc, device="cpu")
    with pytest.raises(ValueError, match="trunk: family 'encdec' .* use encdec.trunk"):
        tlm.trunk(enc_params, enc, toks)
    with pytest.raises(ValueError, match="use encdec.decode_step"):
        tlm.decode_step(enc_params, enc, toks[:, :1], tlm.init_cache(enc, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match="loss_fn: family 'encdec' .* use encdec.loss_fn"):
        tlm.loss_fn(enc_params, enc, toks, toks)
    for cfg, p in ((t_smoke("internvl2_76b"), None), (moe, params)):
        p = p if p is not None else tlm.init_params(cfg, device="cpu")
        loss, _ = tlm.loss_fn(p, cfg, toks, toks)
        assert bool(torch.isfinite(loss))


def test_sample_logits_matches_reference():
    rng = np.random.default_rng(0)
    row = rng.normal(size=64)
    for sp_args in [dict(), dict(temperature=0.8, top_k=5), dict(temperature=1.0, top_p=0.7)]:
        jsp, tsp = jlm.SamplingParams(**sp_args), tlm.SamplingParams(**sp_args)
        for pos in range(4):
            a = jlm.sample_logits(row, jsp, np.random.default_rng([1, 2, pos]))
            b = tlm.sample_logits(row, tsp, np.random.default_rng([1, 2, pos]))
            assert a == b
