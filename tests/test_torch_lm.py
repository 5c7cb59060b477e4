"""Port parity: the serving forward of ``repro_torch.models.lm`` against
``repro.models.lm`` on the reference's own weights (smollm_360m SMOKE,
float32), dense and with 1/2-bit packed FFN carriers."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(w_bits):
    jc = dataclasses.replace(j_smoke("smollm_360m"), w_bits=w_bits)
    tc = dataclasses.replace(t_smoke("smollm_360m"), w_bits=w_bits)
    return jc, tc


def _weights(w_bits, seed=0):
    jc, tc = _configs(w_bits)
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


def test_port_configs_match_reference():
    for name in ("smollm_360m", "smollm-360m"):
        from repro.configs import get_config as j_full
        from repro_torch.configs import get_config as t_full

        assert dataclasses.asdict(t_full(name)) == dataclasses.asdict(j_full(name))
        assert dataclasses.asdict(t_smoke(name)) == dataclasses.asdict(j_smoke(name))
    with pytest.raises(ValueError, match="smollm_360m"):
        t_full("olmoe_1b_7b")


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


@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_prefill_with_cache_matches_reference(w_bits):
    jc, tc, jp, _, params = _weights(w_bits)
    rng = np.random.default_rng(w_bits)
    tokens = rng.integers(0, jc.vocab, size=(2, 12)).astype(np.int32)
    lg, ks, vs = jlm.prefill_with_cache(jp, jc, jnp.asarray(tokens), 9)
    tlg, tks, tvs = tlm.prefill_with_cache(params, tc, _t(tokens), 9)
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


@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_decode_step_paged_matches_reference(w_bits):
    jc, tc, jp, _, params = _weights(w_bits)
    pk, pv = _pool(jc, 40, 10 + w_bits)
    # three lanes at different depths over private rows; row 0 is scratch
    row_table = np.zeros((3, 12), np.int32)
    row_table[0, :8] = np.arange(4, 12)
    row_table[1, :12] = np.arange(12, 24)
    row_table[2, :4] = np.arange(30, 34)
    lengths = np.array([5, 11, 0], np.int32)
    token = np.array([[3], [100], [511]], np.int32)
    lg, jk, jv = jlm.decode_step_paged(
        jp, jc, jnp.asarray(token), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(row_table), jnp.asarray(lengths),
    )
    tk, tv = _t(pk), _t(pv)
    tlg, tk2, tv2 = tlm.decode_step_paged(
        params, tc, _t(token), tk, tv, _t(row_table), _t(lengths)
    )
    assert tk2 is tk and tv2 is tv  # the pool is updated in place
    _close(tlg, lg)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_prefill_chunk_paged_matches_reference(w_bits):
    jc, tc, jp, _, params = _weights(w_bits)
    pk, pv = _pool(jc, 32, 20 + w_bits)
    c, start, n = 8, 6, 5  # a 5-token final chunk after a 6-token prefix
    row_table = np.zeros((1, 16), np.int32)
    row_table[0, :12] = np.arange(4, 16)
    write_rows = np.zeros((1, c), np.int32)  # padding -> scratch row 0
    write_rows[0, :n] = row_table[0, start : start + n]
    tokens = np.zeros((1, c), np.int32)
    tokens[0, :n] = np.random.default_rng(w_bits).integers(0, jc.vocab, n)
    lg, jk, jv = jlm.prefill_chunk_paged(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(row_table), jnp.asarray(write_rows),
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
    _, tc = _configs(0)
    with pytest.raises(ValueError, match="not ported"):
        tlm.init_params(dataclasses.replace(tc, family="moe"), device="cpu")


def test_sample_logits_matches_reference():
    rng = np.random.default_rng(0)
    row = rng.normal(size=64)
    for sp_args in [dict(), dict(temperature=0.8, top_k=5), dict(temperature=1.0, top_p=0.7)]:
        jsp, tsp = jlm.SamplingParams(**sp_args), tlm.SamplingParams(**sp_args)
        for pos in range(4):
            a = jlm.sample_logits(row, jsp, np.random.default_rng([1, 2, pos]))
            b = tlm.sample_logits(row, tsp, np.random.default_rng([1, 2, pos]))
            assert a == b
