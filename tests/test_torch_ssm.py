"""Port parity for ``repro_torch.models.ssm`` (Mamba2 / SSD) against
``repro.models.ssm``: the chunked SSD scan (with and without a carried
state, S a multiple of the chunk and not, and a prime S longer than the
chunk, which the reference's rule runs in chunks of one token), the
one-token recurrence, the causal conv (with and without a carried buffer)
and its decode step, on the same seeded float32 inputs, at the stated
tolerances (1e-4 relative, 1e-5 absolute)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BT, H, P, N = 2, 4, 8, 16  # the zamba2 smoke config's SSM head geometry, 2 lanes
CHUNK = 16  # the smoke config's ssm_chunk


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(s, seed=0):
    """Seeded SSD inputs: x (Bt, S, H, P), dt > 0 (Bt, S, H) as the block's
    softplus makes it, a_log and d_skip (H,), b and c (Bt, S, N), and a
    carried state h0 (Bt, H, P, N)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(BT, s, H, P)).astype(f),
        dt=np.log1p(np.exp(rng.normal(size=(BT, s, H)))).astype(f),
        a_log=(0.3 * rng.normal(size=(H,))).astype(f),
        b=rng.normal(size=(BT, s, N)).astype(f),
        c=rng.normal(size=(BT, s, N)).astype(f),
        d_skip=rng.normal(size=(H,)).astype(f),
        h0=rng.normal(size=(BT, H, P, N)).astype(f),
    )


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_segsum_matches_reference():
    a = np.random.default_rng(1).normal(size=(3, 5, 12)).astype(np.float32)
    want = np.asarray(jssm.segsum(jnp.asarray(a)))
    got = tssm.segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s", [32, 24, 37], ids=["multiple", "ragged", "prime"])
@pytest.mark.parametrize("carried", [False, True], ids=["h0_none", "h0"])
def test_ssd_chunked_matches_reference(s, carried):
    """S = 32 runs two chunks of 16, S = 24 chunks of 12 (the largest
    divisor below 16), and the prime S = 37 thirty-seven chunks of one;
    each from the zero state and from a carried one."""
    inp = _inputs(s)
    h0 = inp["h0"] if carried else None
    args = [inp[k] for k in ("x", "dt", "a_log", "b", "c", "d_skip")]
    y_j, h_j = jssm.ssd_chunked(*map(jnp.asarray, args), CHUNK,
                                h0=None if h0 is None else jnp.asarray(h0))
    y_t, h_t = tssm.ssd_chunked(*map(torch.from_numpy, args), CHUNK,
                                h0=None if h0 is None else torch.from_numpy(h0))
    assert tssm.chunk_len(s, CHUNK) == {32: 16, 24: 12, 37: 1}[s]
    assert y_t.dtype == torch.float32 and h_t.shape == (BT, H, P, N)
    _close(y_t, y_j)
    _close(h_t, h_j)


def test_ssd_chunked_resumes_from_its_own_final_state():
    """Two halves, the second from the first's final state, give the whole
    sequence's outputs and state (the chunked-prefill invariant)."""
    inp = _inputs(32, seed=2)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    rest = (t["a_log"],)
    y, h = tssm.ssd_chunked(t["x"], t["dt"], *rest, t["b"], t["c"], t["d_skip"], CHUNK)
    y1, h1 = tssm.ssd_chunked(t["x"][:, :20], t["dt"][:, :20], *rest, t["b"][:, :20],
                              t["c"][:, :20], t["d_skip"], CHUNK)
    y2, h2 = tssm.ssd_chunked(t["x"][:, 20:], t["dt"][:, 20:], *rest, t["b"][:, 20:],
                              t["c"][:, 20:], t["d_skip"], CHUNK, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=RTOL, atol=ATOL)


def test_ssd_decode_step_matches_reference():
    inp = _inputs(3, seed=3)
    args = (inp["h0"], inp["x"][:, 0], inp["dt"][:, 0], inp["a_log"], inp["b"][:, 0],
            inp["c"][:, 0], inp["d_skip"])
    y_j, h_j = jssm.ssd_decode_step(*map(jnp.asarray, args))
    y_t, h_t = tssm.ssd_decode_step(*map(torch.from_numpy, args))
    _close(y_t, y_j)
    _close(h_t, h_j)


def test_ssd_decode_steps_continue_the_chunked_scan():
    """The recurrence fed token by token from a prefix's final state gives
    the chunked scan's outputs and state over the whole sequence."""
    inp = _inputs(20, seed=4)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    y, h = tssm.ssd_chunked(t["x"], t["dt"], t["a_log"], t["b"], t["c"], t["d_skip"], CHUNK)
    _, state = tssm.ssd_chunked(t["x"][:, :16], t["dt"][:, :16], t["a_log"], t["b"][:, :16],
                                t["c"][:, :16], t["d_skip"], CHUNK)
    for i in range(16, 20):
        yi, state = tssm.ssd_decode_step(state, t["x"][:, i], t["dt"][:, i], t["a_log"],
                                         t["b"][:, i], t["c"][:, i], t["d_skip"])
        np.testing.assert_allclose(yi.numpy(), y[:, i].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state.numpy(), h.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("carried", [False, True], ids=["zero_pad", "state"])
def test_causal_conv_matches_reference(carried):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BT, 9, 24)).astype(np.float32)
    w = (0.3 * rng.normal(size=(4, 24))).astype(np.float32)
    st = rng.normal(size=(BT, 3, 24)).astype(np.float32) if carried else None
    want = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if st is None else jnp.asarray(st))
    got = tssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           None if st is None else torch.from_numpy(st))
    _close(got, want)


def test_conv_decode_step_matches_reference_and_the_sequence_conv():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(BT, 7, 24)).astype(np.float32)
    w = (0.3 * rng.normal(size=(4, 24))).astype(np.float32)
    buf = np.zeros((BT, 3, 24), np.float32)
    jbuf, tbuf = jnp.asarray(buf), torch.from_numpy(buf)
    seq = tssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    for i in range(x.shape[1]):
        yj, jbuf = jssm.conv_decode_step(jbuf, jnp.asarray(x[:, i]), jnp.asarray(w))
        yt, tbuf = tssm.conv_decode_step(tbuf, torch.from_numpy(x[:, i]), torch.from_numpy(w))
        _close(yt, yj)
        _close(tbuf, jbuf)
        np.testing.assert_allclose(yt.numpy(), seq[:, i].numpy(), rtol=RTOL, atol=ATOL)
