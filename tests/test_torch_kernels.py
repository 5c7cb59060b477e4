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
from repro_torch.kernels import mvau as tmvau  # noqa: E402
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


MVAU_SHAPES = [(8, 32, 16), (16, 64, 128), (128, 256, 128), (33, 72, 50)]


def _mvau_case(rng, lead, k, n, bits, n_levels):
    x, carrier, _ = _packed_case(rng, lead, k + (-k) % (8 // bits), n, bits)
    x = np.ascontiguousarray(x[..., :k])  # a ragged K keeps the carrier's padding codes
    thresholds = np.sort(rng.normal(scale=np.sqrt(k), size=(n, n_levels)), axis=1).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], size=(n,)).astype(np.float32)
    return x, carrier, thresholds, signs


def _mvau_both(x, carrier, thresholds, signs, bits, k, offset):
    want = jops.mvau(
        jnp.asarray(x), jnp.asarray(carrier), jnp.asarray(thresholds), jnp.asarray(signs),
        bits=bits, k=k, offset=offset, interpret=True,
    )
    got = tops.mvau(
        torch.from_numpy(x), torch.from_numpy(carrier), torch.from_numpy(thresholds),
        torch.from_numpy(signs), bits=bits, k=k, offset=offset,
    )
    return got, np.asarray(want)


@pytest.mark.parametrize("bits", [1, 2])
@pytest.mark.parametrize("m,k,n", MVAU_SHAPES, ids=["small", "wide", "aligned", "ragged"])
@pytest.mark.parametrize("n_levels", [1, 3, 7])
def test_mvau_plain_matches_pallas_interpret(bits, m, k, n, n_levels):
    """The cases of ``tests/test_kernels.py``'s mvau sweep: int32 levels equal."""
    rng = np.random.default_rng(7 + m + k + n + bits + n_levels)
    x, carrier, thresholds, signs = _mvau_case(rng, (m,), k, n, bits, n_levels)
    offset = -(n_levels + 1) // 2
    got, want = _mvau_both(x, carrier, thresholds, signs, bits, k, offset)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "lead,k,n,bits,n_levels",
    [((2, 12), 32, 16, 1, 1), ((2, 3, 5), 64, 24, 2, 3), ((4, 6), 100, 70, 1, 15)],
    ids=["batched", "batched3", "ragged_k_l15"],
)
def test_mvau_plain_leading_dims_and_ragged_k(lead, k, n, bits, n_levels):
    """Leading batch dims flatten as the reference's ``ops.mvau`` does; K=100
    at 1 bit leaves padding codes (-1) in the carrier's last row; some
    thresholds are +inf (a level never reached)."""
    rng = np.random.default_rng(sum(lead) + k + n)
    x, carrier, thresholds, signs = _mvau_case(rng, lead, k, n, bits, n_levels)
    thresholds[: n // 3, n_levels // 2:] = np.inf
    got, want = _mvau_both(x, carrier, thresholds, signs, bits, k, -2)
    assert tuple(got.shape) == lead + (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mvau_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 12))
    carrier = torch.zeros((2, 5), dtype=torch.uint8)  # ceil(12 / 8) rows at 1 bit
    thr, sg = torch.zeros((5, 3)), torch.ones(5)
    assert tmvau.mvau(x, carrier, thr, sg, 1, 12).shape == (4, 5)
    with pytest.raises(ValueError):  # 4-bit weights are not an MVAU width
        tmvau.mvau(x, torch.zeros((6, 5), dtype=torch.uint8), thr, sg, 4, 12)
    with pytest.raises(ValueError):  # carrier rows disagree with K
        tmvau.mvau(x, torch.zeros((3, 5), dtype=torch.uint8), thr, sg, 1, 12)
    with pytest.raises(ValueError):  # more thresholds than the kernel stages
        tmvau.mvau(x, carrier, torch.zeros((5, 16)), sg, 1, 12)
    with pytest.raises(ValueError):  # x must be f32 (ops.mvau casts)
        tmvau.mvau(x.double(), carrier, thr, sg, 1, 12)
    with pytest.raises(ValueError):  # signs per column
        tmvau.mvau(x, carrier, thr, torch.ones(4), 1, 12)


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
