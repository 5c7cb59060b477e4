"""Port parity: the plain versions of the port's kernels against the
reference's Pallas kernels run in interpret mode on the CPU, and the
attention ops against ``repro.models.attention``.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.quant.quantizers import pack_bits  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import packed_matmul as tpm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402


def _packed_case(rng, lead, k, n, bits):
    x = rng.normal(size=lead + (k,)).astype(np.float32)
    codes = rng.integers(0, 2 if bits == 1 else 3, size=(k, n)).astype(np.uint8)
    carrier = np.array(pack_bits(jnp.asarray(codes), bits))
    scale = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    return x, carrier, scale


@pytest.mark.parametrize("bits", [1, 2])
@pytest.mark.parametrize(
    "lead,k,n",
    [((8,), 32, 16), ((33,), 72, 50), ((1,), 8, 1), ((2, 5), 64, 24)],
    ids=["aligned", "ragged", "m1", "batched"],
)
def test_packed_matmul_plain_matches_pallas_interpret(bits, lead, k, n):
    rng = np.random.default_rng(11 + k + n + bits)
    x, carrier, scale = _packed_case(rng, lead, k, n, bits)
    want = jops.packed_matmul(
        jnp.asarray(x), jnp.asarray(carrier), jnp.asarray(scale),
        bits=bits, k=k, interpret=True,
    )
    got = tops.packed_matmul(
        torch.from_numpy(x), torch.from_numpy(carrier), torch.from_numpy(scale),
        bits=bits, k=k,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == lead + (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_packed_matmul_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 12))
    carrier = torch.zeros((3, 5), dtype=torch.uint8)
    scale = torch.ones(5)
    with pytest.raises(ValueError):  # K=12 not a multiple of 8 at 1 bit
        tpm.packed_matmul(x, carrier, scale, 1, 12)
    with pytest.raises(ValueError):  # 4-bit is not on the serve path
        tpm.packed_matmul(x, torch.zeros((6, 5), dtype=torch.uint8), scale, 4, 12)
    with pytest.raises(ValueError):  # carrier rows disagree with K
        tpm.packed_matmul(torch.zeros((4, 16)), carrier, scale, 2, 16)
    with pytest.raises(ValueError):  # scale must be f32
        tpm.packed_matmul(x, carrier, scale.double(), 2, 12)


FLASH_CASES = [
    # (bh, bkv, sq, sk, d, causal, window, q_offset, qb, kb)
    (4, 4, 16, 16, 32, True, 0, 0, 8, 8),
    (6, 2, 16, 16, 32, True, 0, 0, 8, 8),  # GQA g=3
    (3, 1, 16, 24, 16, False, 0, 0, 8, 8),  # not causal, Sq != Sk
    (2, 1, 24, 24, 32, True, 5, 0, 8, 8),  # sliding window
    (2, 2, 8, 24, 32, True, 0, 16, 8, 8),  # q_offset (a chunk over its prefix)
    (4, 2, 8, 32, 32, True, 6, 12, 8, 8),  # window and q_offset together
]


@pytest.mark.parametrize(
    "bh,bkv,sq,sk,d,causal,window,q_offset,qb,kb", FLASH_CASES,
    ids=["causal", "gqa", "full", "window", "q_offset", "window_offset"],
)
def test_flash_fwd_plain_matches_pallas_interpret(
    bh, bkv, sq, sk, d, causal, window, q_offset, qb, kb
):
    rng = np.random.default_rng(bh * 7 + sq + sk + window + q_offset)
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k = rng.normal(size=(bkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(bkv, sk, d)).astype(np.float32)
    want_o, want_lse = jfa.flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, qb=qb, kb=kb, q_offset=q_offset, interpret=True,
    )
    got_o, got_lse = tfa.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=q_offset,
    )
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got_lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5
    )


def test_flash_fwd_wrapper_rejects_bad_layouts():
    q = torch.zeros((4, 8, 32))
    with pytest.raises(ValueError):  # BH not a multiple of BKV
        tfa.flash_fwd(q, torch.zeros((3, 8, 32)), torch.zeros((3, 8, 32)))
    with pytest.raises(ValueError):  # D mismatch
        tfa.flash_fwd(q, torch.zeros((2, 8, 16)), torch.zeros((2, 8, 16)))
    with pytest.raises(ValueError):  # mixed dtypes
        tfa.flash_fwd(q, torch.zeros((2, 8, 32)), torch.zeros((2, 8, 32)).double())


@pytest.mark.parametrize(
    "b,sq,hq,hkv,d,window,q_offset",
    [(2, 16, 4, 2, 32, 0, 0), (1, 24, 3, 1, 32, 7, 0), (1, 8, 6, 2, 16, 0, 8)],
    ids=["gqa", "window", "q_offset"],
)
def test_flash_attention_matches_reference_model_path(b, sq, hq, hkv, d, window, q_offset):
    rng = np.random.default_rng(b + sq + hq + window)
    sk = sq + q_offset
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    want = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=q_offset,
    )
    got = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_offset=q_offset,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(3 + window)
    b, s, hq, hkv, d = 3, 12, 4, 2, 16
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    lens = np.array([[1], [7], [12]], np.int32)
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        window=window,
    )
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens).long(), window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_chunk_attention_matches_reference(window):
    rng = np.random.default_rng(5 + window)
    b, c, s, hq, hkv, d = 2, 4, 16, 4, 1, 16
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    kr = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vr = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    q_pos = np.stack([np.arange(3, 3 + c), np.arange(9, 9 + c)]).astype(np.int32)
    want = jattn.chunk_attention(
        jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), jnp.asarray(q_pos),
        window=window,
    )
    got = tattn.chunk_attention(
        torch.from_numpy(q), torch.from_numpy(kr), torch.from_numpy(vr),
        torch.from_numpy(q_pos).long(), window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the chunk prefill path computes the same through the flash kernel
    # (one shared offset per call): lane 0 at q_offset 3
    flash = tattn.flash_attention(
        torch.from_numpy(q[:1]), torch.from_numpy(kr[:1]), torch.from_numpy(vr[:1]),
        causal=True, window=window, q_offset=3,
    )
    np.testing.assert_allclose(flash.numpy(), got[:1].numpy(), rtol=1e-5, atol=1e-5)
