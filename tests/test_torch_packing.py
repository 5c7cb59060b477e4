"""Port parity: bit packing (``repro_torch.quant``, ``lm.make_packed``,
``ops.pack_weights``) gives the reference's carrier bytes."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant import quantizers as jq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.quant import quantizers as tq  # noqa: E402


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("shape", [(8, 3), (16, 5, 2), (64, 1)])
def test_pack_unpack_bits_match_reference(bits, shape):
    rng = np.random.default_rng(bits * 100 + len(shape))
    codes = rng.integers(0, 2**bits, size=shape).astype(np.uint8)
    want = np.asarray(jq.pack_bits(jnp.asarray(codes), bits))
    got = tq.pack_bits(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tq.unpack_bits(got, bits, shape[0])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.unpack_bits(jnp.asarray(want), bits, shape[0]))
    )


def test_pack_bits_rejects_ragged_reduction_dim():
    with pytest.raises(ValueError):
        tq.pack_bits(torch.zeros((7, 2), dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        tq.pack_bits(torch.zeros((8, 2), dtype=torch.uint8), 3)


@pytest.mark.parametrize("bits", [1, 2])
@pytest.mark.parametrize("shape", [(2, 64, 24), (32, 16)])
def test_make_packed_matches_reference(bits, shape):
    rng = np.random.default_rng(7 + bits)
    w = rng.normal(size=shape).astype(np.float32)
    want = jlm.make_packed(jnp.asarray(w), bits)
    got = tlm.make_packed(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(got["packed"].numpy(), np.asarray(want["packed"]))
    np.testing.assert_allclose(
        got["scale"].numpy(), np.asarray(want["scale"]), rtol=1e-6
    )
    codes = tlm._unpack_codes(got["packed"], bits)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jlm._unpack_codes(want["packed"], bits))
    )


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_weights_matches_reference(bits):
    rng = np.random.default_rng(bits)
    k, n = 13, 6  # K not a multiple of 8/bits: padded to a byte boundary
    if bits == 4:
        w = rng.integers(-8, 8, size=(k, n)).astype(np.float32)
    else:
        w = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jops.pack_weights(jnp.asarray(w), bits))
    got = tops.pack_weights(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.decode_weights(got, bits, k).numpy(),
        np.asarray(jref.decode_weights(jnp.asarray(want), bits, k)),
    )


def test_pack_weights_8bit_round_trips():
    # the reference's pack_bits stops at 4 bits; the port's carries 8-bit
    # codes one per byte, decoded by subtracting 128
    rng = np.random.default_rng(8)
    w = rng.integers(-128, 128, size=(9, 4)).astype(np.float32)
    got = tops.pack_weights(torch.from_numpy(w), 8)
    assert got.shape == (9, 4)
    np.testing.assert_array_equal(tref.decode_weights(got, 8, 9).numpy(), w)
