"""Port parity: the plain versions of the port's kernels against the
reference's Pallas kernels run in interpret mode on the CPU, and the
attention ops against ``repro.models.attention``.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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
    [((8,), 32, 16), ((33,), 72, 50), ((1,), 8, 1), ((2, 5), 64, 24), ((40,), 200, 48)],
    ids=["aligned", "ragged", "m1", "batched", "m40_k200"],
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


# (layer, M, K, N) of CNV's 1/2-bit layers at batch 256, as chip_smoke.py's
# cnv_mvau_shapes gives them, then ragged ones
CNV_MVAU_LAYERS = [
    ("conv1", 200704, 576, 64), ("conv2", 36864, 576, 128), ("conv3", 25600, 1152, 128),
    ("conv4", 2304, 1152, 256), ("conv5", 256, 2304, 256), ("fc0", 256, 256, 512),
    ("fc1", 256, 512, 512),
]
RAGGED_MVAU = [
    ("m37_k2300", 37, 2300, 70), ("m5", 5, 100, 70), ("n3", 300, 24, 3),
    ("m1000", 1000, 100, 70), ("m1", 1, 8, 1),
]


@pytest.mark.parametrize("name,m,k,n", CNV_MVAU_LAYERS + RAGGED_MVAU,
                         ids=[c[0] for c in CNV_MVAU_LAYERS + RAGGED_MVAU])
def test_mvau_split_plan_covers_k_and_fills_the_card(name, m, k, n):
    """The kernel's K split: every split gets at least one K step, the
    splits cover K once, a cluster holds at most MAX_SPLITS blocks, the
    narrow CNV layers reach at least 100 blocks on the H100's 132 SMs, and
    a layer with as many 64x64 tiles as SMs is not split."""
    sms = 132
    splits, cps = tmvau.split_plan(m, k, n, sms)
    assert 1 <= splits <= tpm.MAX_SPLITS and cps >= 1
    bounds = [min(s * cps * tmvau.BK, k) for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
    tiles = -(-m // tmvau.BM) * -(-n // tmvau.BN)
    if name in ("conv5", "fc0", "fc1"):
        assert splits * tiles >= 100
    if tiles >= sms:
        assert splits == 1


# chip_smoke.py's MVAU_TIE_TOL: a level may differ only where the plain
# sign*acc lies within this of a threshold (relative to 1 + |T|)
MVAU_TIE_TOL = 1e-5
ACT_SCALE = np.float32(2.0 / np.sqrt(1.5))  # the LSQ scale of CNV's 2-bit activations


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 rounded to the nearest bf16 (ties to even), as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _split3(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's split of f32 x into bf16 parts: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each difference taken in f32."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


@pytest.mark.parametrize("kind", ["levels", "wide_normals"])
def test_mvau_three_part_bf16_split_is_exact(kind):
    """hi + mid + lo == x bit for bit, each part a bf16 value: on CNV's
    columns (2-bit levels times their scale) and on normals spread over
    2^-60..2^60."""
    rng = np.random.default_rng(16)
    if kind == "levels":
        x = rng.integers(-2, 2, size=(64, 96)).astype(np.float32) * ACT_SCALE
    else:
        x = (rng.normal(size=(64, 96)) * 2.0 ** rng.integers(-60, 61, size=(64, 96)))
        x = x.astype(np.float32)
    parts = _split3(x)
    for p in parts:
        assert np.array_equal(_bf16(p), p)
    total = parts[0].astype(np.float64) + parts[1].astype(np.float64) + parts[2].astype(np.float64)
    assert np.array_equal(total, x.astype(np.float64))


@pytest.mark.parametrize("bits", [1, 2])
@pytest.mark.parametrize("m,k,n", [(256, 576, 64), (64, 2304, 32), (37, 2300, 70)],
                         ids=["conv1_k", "conv5_k", "ragged"])
def test_mvau_split_passes_give_the_plain_levels(bits, m, k, n):
    """The kernel's arithmetic, on the CPU: the three parts of x times the
    decoded weights, each pass summed in f32, added (hi + mid) + lo and
    thresholded, give ``mvau_ref``'s levels but within MVAU_TIE_TOL of a
    threshold. On 2-bit levels times a scale each pass's f32 sums are exact
    (they equal the float64 sums), whatever order they are taken in."""
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(m + k + n + bits)
    x = rng.integers(-2, 2, size=(m, k)).astype(np.float32) * ACT_SCALE
    codes = rng.integers(0, 2 if bits == 1 else 3, size=(k + (-k) % (8 // bits), n))
    carrier = torch.from_numpy(np.array(pack_bits(jnp.asarray(codes.astype(np.uint8)), bits)))
    thr = np.sort(rng.normal(size=(n, 3)) * ACT_SCALE * np.sqrt(k), axis=1).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], size=(n,)).astype(np.float32)
    w = tref.decode_weights(carrier, bits, k)
    passes = []
    for p in _split3(x):
        acc = torch.from_numpy(p) @ w
        assert np.array_equal(acc.double().numpy(), p.astype(np.float64) @ w.double().numpy())
        passes.append(acc)
    value = (passes[0] + passes[1]) + passes[2]
    thr_t, signs_t = torch.from_numpy(thr), torch.from_numpy(signs)
    got = ((value * signs_t)[..., None] >= thr_t[None]).sum(dim=-1, dtype=torch.int32) - 2
    want = tref.mvau_ref(torch.from_numpy(x), carrier, thr_t, signs_t, -2, bits, k)
    plain = (torch.from_numpy(x) @ w) * signs_t
    near = ((plain[..., None] - thr_t[None]).abs() <= MVAU_TIE_TOL * (1 + thr_t.abs()[None])).any(-1)
    assert not bool(((got != want) & ~near).any())


FLASH_CASES = [
    # (bh, bkv, sq, sk, d, causal, window, q_offset, qb, kb)
    (4, 4, 16, 16, 32, True, 0, 0, 8, 8),
    (6, 2, 16, 16, 32, True, 0, 0, 8, 8),  # GQA g=3
    (3, 1, 16, 24, 16, False, 0, 0, 8, 8),  # not causal, Sq != Sk
    (2, 1, 24, 24, 32, True, 5, 0, 8, 8),  # sliding window
    (2, 2, 8, 24, 32, True, 0, 16, 8, 8),  # q_offset (a chunk over its prefix)
    (4, 2, 8, 32, 32, True, 6, 12, 8, 8),  # window and q_offset together
    (4, 2, 16, 16, 64, True, 0, 0, 8, 8),  # D 64 (the serve path's head dim)
    (2, 1, 16, 32, 128, True, 0, 16, 8, 8),  # D 128 with q_offset
    (2, 1, 16, 16, 32, True, 8, 16, 8, 8),  # rows 23-31 (positions) see no key
]


@pytest.mark.parametrize(
    "bh,bkv,sq,sk,d,causal,window,q_offset,qb,kb", FLASH_CASES,
    ids=["causal", "gqa", "full", "window", "q_offset", "window_offset", "d64", "d128",
         "rows_without_keys"],
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


def test_flash_fwd_plain_rows_without_keys_give_zero_and_neg_lse():
    """A row whose window ends before the first key (here every row: window
    128 at q_offset 256 over 64 keys, and the last rows of the partial
    case) gets out 0 and lse -1e30, as the reference's kernel."""
    rng = np.random.default_rng(23)
    for sq, sk, window, q_offset, blind in ((16, 16, 128, 256, 16), (16, 16, 8, 16, 9)):
        q = rng.normal(size=(2, sq, 32)).astype(np.float32)
        k = rng.normal(size=(1, sk, 32)).astype(np.float32)
        out, lse = tfa.flash_fwd(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
            causal=True, window=window, q_offset=q_offset,
        )
        assert bool((out[:, sq - blind:] == 0).all())
        assert float(lse[:, sq - blind:].max()) <= -1e29
        assert bool((lse[:, : sq - blind] > -1e29).all())


@pytest.mark.parametrize(
    "m,k,n,bits",
    [(256, 960, 2560, 2), (512, 960, 2560, 1), (256, 2560, 960, 2), (512, 2560, 960, 1),
     (17, 968, 1000, 1), (300, 968, 1000, 2), (33, 972, 999, 2), (4096, 64, 64, 1)],
    ids=["m256_d_ff", "m512_d_ff", "m256_ff_d", "m512_ff_d", "m17_ragged", "m300_ragged",
         "m33_k972", "one_step"],
)
def test_packed_split_plan_fills_the_card_and_splits_k_by_per(m, k, n, bits):
    """The tensor-core path's K split: every split gets at least one K
    step, the splits cover the sweep once, each split's K range is a
    multiple of 8/bits (whole carrier rows), a cluster holds at most
    MAX_SPLITS blocks, and the serve path's four prefill shapes put at least
    one block on each of the H100's 132 SMs."""
    sms = 132
    splits, cps = tpm.split_plan(m, k, n, sms)
    nk = -(-k // tpm.BK)
    assert 1 <= splits <= tpm.MAX_SPLITS
    assert (splits - 1) * cps < nk <= splits * cps
    per = 8 // bits
    bounds = [min(s * cps * tpm.BK, k) for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(hi > lo and (hi - lo) % per == 0 for lo, hi in zip(bounds, bounds[1:]))
    blocks = splits * -(-m // tpm.BM) * -(-n // tpm.BN)
    if m in (256, 512) and {k, n} == {960, 2560}:
        assert blocks >= sms


@pytest.mark.parametrize(
    "k,n,bits",
    [(960, 2560, 2), (2560, 960, 2), (960, 960, 1), (968, 1000, 2)],
    ids=["d_ff", "ff_d", "d_d", "ragged"],
)
def test_mma_plan_does_not_follow_m(k, n, bits):
    """The tensor-core path plans its K split from K and N alone
    (``split_plan`` at ``PLAN_ROWS`` rows), so a row's K sum is taken in
    the same order at every M the path serves, which is what makes a
    prompt's rows the same bits in a bucket, a chunk or after a prefix-cache
    hit. The plan covers the sweep in whole carrier rows, and at the serve
    shapes the chunk's M puts a block on each of the 132 SMs."""
    sms = 132
    splits, cps = tpm.mma_plan(k, n, sms)
    assert (splits, cps) == tpm.split_plan(tpm.PLAN_ROWS, k, n, sms)
    nk = -(-k // tpm.BK)
    assert 1 <= splits <= tpm.MAX_SPLITS and (splits - 1) * cps < nk <= splits * cps
    bounds = [min(s * cps * tpm.BK, k) for s in range(splits + 1)]
    assert all(hi > lo and (hi - lo) % (8 // bits) == 0 for lo, hi in zip(bounds, bounds[1:]))
    if {k, n} == {960, 2560}:
        assert splits * -(-tpm.PLAN_ROWS // tpm.BM) * -(-n // tpm.BN) >= sms


@pytest.mark.parametrize(
    "m,k,n,bits",
    [(8, 960, 2560, 2), (8, 960, 2560, 1), (8, 2560, 960, 2), (8, 2560, 960, 1),
     (16, 2560, 960, 2), (5, 972, 1000, 2), (3, 8, 999, 1)],
    ids=["d_ff_2bit", "d_ff_1bit", "ff_d_2bit", "ff_d_1bit", "m16", "ragged_k972",
         "one_carrier_row"],
)
def test_gemv_split_plan_fills_the_card_and_splits_k_by_per(m, k, n, bits):
    """The GEMV's K split (``split_plan`` with the GEMV's geometry, as the
    wrapper calls it): at most a portable cluster of splits, each with at
    least one K step; together they cover the sweep once, each K range
    whole carrier rows; and the four decode shapes put at least one block
    on each of the H100's 132 SMs, though their columns alone give 30-80."""
    sms = 132
    splits, cps = tpm.split_plan(m, k, n, sms, bm=tpm.GEMV_MAX_M, bn=tpm.GEMV_BN, bk=tpm.GEMV_BK)
    nk = -(-k // tpm.GEMV_BK)
    assert 1 <= splits <= tpm.MAX_SPLITS
    assert (splits - 1) * cps < nk <= splits * cps
    per = 8 // bits
    bounds = [min(s * cps * tpm.GEMV_BK, k) for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(hi > lo and (hi - lo) % per == 0 for lo, hi in zip(bounds, bounds[1:]))
    blocks = splits * -(-n // tpm.GEMV_BN)
    assert m <= tpm.GEMV_MAX_M  # one block row: the carrier is read once
    if m == 8 and {k, n} == {960, 2560}:
        assert -(-n // tpm.GEMV_BN) < sms <= blocks


def test_launch_counter_counts_by_route_and_resets():
    c = tpm.COUNTER
    saved = (c.count, dict(c.routes))
    try:
        tops.reset_launch_counts()
        c.add("mma")
        c.add("mma")
        c.add("gemv")
        assert tops.launch_counts()["packed_matmul"] == 3
        assert tops.launch_routes() == {"packed_matmul": {"mma": 2, "gemv": 1}}
        tops.reset_launch_counts()
        assert tops.launch_counts()["packed_matmul"] == 0 and tops.launch_routes() == {}
    finally:
        c.count, c.routes = saved[0], saved[1]


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


# flash_bwd: the plain version against the Pallas backward in interpret
# mode. (sq, sk, causal, window, q_offset); the Pallas kernel needs blocks
# that divide Sq and Sk (qb=16, kb=32).
FLASH_BWD_CASES = [
    (64, 64, True, 0, 0),
    (64, 64, True, 20, 0),  # sliding window
    (32, 64, True, 0, 32),  # q_offset: a chunk over its prefix
    (32, 64, True, 12, 32),  # window and q_offset together
    (32, 64, False, 0, 0),  # not causal, Sq != Sk
]
# f32 sums of at most 64 products, in another order than the Pallas
# kernel's 16 x 32 blocks
FLASH_BWD_TOL = 1e-5


def _flash_bwd_inputs(rng, bh, bkv, sq, sk, d):
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k = rng.normal(size=(bkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(bkv, sk, d)).astype(np.float32)
    do = rng.normal(size=(bh, sq, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("g", [1, 2], ids=["g1", "g2"])
@pytest.mark.parametrize(
    "sq,sk,causal,window,q_offset", FLASH_BWD_CASES,
    ids=["causal", "window", "q_offset", "window_offset", "full"],
)
def test_flash_bwd_plain_matches_pallas_interpret(g, sq, sk, causal, window, q_offset):
    bkv, d = 2, 32
    rng = np.random.default_rng(17 * g + sq + sk + window + q_offset)
    q, k, v, do = _flash_bwd_inputs(rng, bkv * g, bkv, sq, sk, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jfa.flash_fwd(jq, jk, jv, qb=16, kb=32, interpret=True, **kw)
    want_dq, dk_g, dv_g = jfa.flash_bwd(
        jq, jk, jv, out, lse, jnp.asarray(do), qb=16, kb=32, interpret=True, **kw
    )
    # sum the per-q-head partials over each GQA group, as ops._fa_bwd does
    want_dk = np.asarray(dk_g).reshape(bkv, g, sk, d).sum(axis=1)
    want_dv = np.asarray(dv_g).reshape(bkv, g, sk, d).sum(axis=1)
    got = tfa.flash_bwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), **kw,
    )
    for a, b in zip(got, (want_dq, want_dk, want_dv)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=FLASH_BWD_TOL, atol=FLASH_BWD_TOL
        )


def test_flash_bwd_masks_rows_that_see_no_key():
    """A row past the window sees no key (lse -1e30): its dq is 0 and it
    adds nothing to dk/dv, with no inf or nan from exp(s + 1e30)."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(a) for a in _flash_bwd_inputs(rng, 2, 1, 8, 16, 32))
    kw = dict(causal=True, window=3, q_offset=20)  # positions 20..27, keys 0..15
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    assert bool((lse <= -1e29).all())
    dq, dk, dv = tfa.flash_bwd(q, k, v, out, lse, do, **kw)
    for t in (dq, dk, dv):
        assert bool(torch.isfinite(t).all()) and not bool(t.any())


def test_flash_bwd_wrapper_rejects_bad_inputs():
    q, k = torch.zeros((4, 8, 32)), torch.zeros((2, 8, 32))
    lse = torch.zeros((4, 8))
    with pytest.raises(ValueError):  # do's shape disagrees with q's
        tfa.flash_bwd(q, k, k, q, lse, torch.zeros((4, 4, 32)))
    with pytest.raises(ValueError):  # lse must be f32 (BH, Sq)
        tfa.flash_bwd(q, k, k, q, lse.double(), q)
    with pytest.raises(ValueError):  # out in another dtype than q
        tfa.flash_bwd(q, k, k, q.double(), lse, q)


@pytest.mark.parametrize(
    "b,sq,hq,hkv,window,q_offset",
    [(1, 64, 4, 2, 0, 0), (2, 32, 2, 2, 12, 0), (1, 32, 4, 1, 0, 32)],
    ids=["gqa", "window", "q_offset"],
)
def test_flash_attention_gradients_match_reference(b, sq, hq, hkv, window, q_offset):
    """The port's differentiable ``ops.flash_attention`` against jax.grad of
    the reference's Pallas path (interpret mode) and of its jnp twin
    ``models/flash.py``, as ``tests/test_kernels.py`` checks the Pallas
    gradients; f32, tolerance 2e-4 as there."""
    from repro.models import flash as jflash

    d, sk = 32, sq + q_offset
    rng = np.random.default_rng(b + sq + hq + window + q_offset)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset)

    def loss_pallas(q, k, v):
        return jnp.sum(jnp.sin(jops.flash_attention(
            q, k, v, q_block=16, kv_block=32, interpret=True, **kw)))

    def loss_twin(q, k, v):
        return jnp.sum(jnp.sin(jflash.flash_attention(q, k, v, **kw)))

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_p = jax.grad(loss_pallas, argnums=(0, 1, 2))(*args)
    want_t = jax.grad(loss_twin, argnums=(0, 1, 2))(*args)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    torch.sum(torch.sin(tops.flash_attention(tq, tk, tv, **kw))).backward()
    for got, a, b_ in zip((tq.grad, tk.grad, tv.grad), want_p, want_t):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(b_), rtol=2e-4, atol=2e-4)
