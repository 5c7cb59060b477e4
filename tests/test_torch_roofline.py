"""Port parity for the whole-step roofline: ``perf.roofline`` against
``repro.perf.roofline`` built from the same numbers, and ``perf.op_analysis``
(the op walk) against the reference's HLO walk (``hlo_analysis``) of the
same step, against hand arithmetic, against the plain versions of the
kernels, and over collectives on a fake process group."""

import dataclasses
import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.perf import hlo_analysis  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mvau as mv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import packed_matmul as pm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import weight_stream as ws  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim.adamw import AdamW as TAdamW  # noqa: E402
from repro_torch.perf import op_analysis as oa  # noqa: E402
from repro_torch.perf import roofline as troof  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

# the reference's package exports a function named ``roofline`` over its module
jroof = importlib.import_module("repro.perf.roofline")
B, S = 2, 64  # the walked steps' batch and sequence


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------- the roofline ----------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    for name, shape in jconfig.SHAPES.items():
        assert troof.model_flops(t_full(arch), tconfig.SHAPES[name]) == jroof.model_flops(
            j_full(arch), shape)


@pytest.mark.parametrize("numbers", [
    (3.1e12, 2.2e10, 1.5e9, 256), (1e9, 4e11, 0.0, 1), (5e14, 1e9, 9e10, 512), (0.0, 0.0, 0.0, 8)])
def test_roofline_report_matches_reference(numbers):
    """Every property of a report built from the same numbers, over the
    same hardware record (passed explicitly: the packages' defaults
    differ, the H100 here, a TPU there)."""
    flops, hbm, coll, n = numbers
    jhw = jroof.HwModel()
    thw = troof.HwModel(name=jhw.name, peak_flops=jhw.peak_flops, hbm_bw=jhw.hbm_bw,
                        ici_bw=jhw.ici_bw)
    kw = dict(name="cell", flops=flops, hbm_bytes=hbm, coll_bytes=coll,
              coll_breakdown={"all-reduce": coll}, model_flops=0.6 * flops * n, n_devices=n)
    t, j = troof.RooflineReport(hw=thw, **kw), jroof.RooflineReport(hw=jhw, **kw)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck", "step_time",
                 "useful_flops_ratio", "roofline_fraction"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.row() == j.row()
    assert troof.HW.peak_flops == 989e12 and troof.HW.hbm_bw == 3.35e12


def test_roofline_reads_an_op_cost():
    cost = oa.analyze(lambda a, b: a @ b, torch.ones(64, 32), torch.ones(32, 16))
    cfg = t_full("smollm_360m")
    shape = tconfig.ShapeConfig("decode_8", 1, 8, "decode")
    rep = troof.roofline("mm", cost, cfg, shape, n_devices=1)
    assert (rep.flops, rep.hbm_bytes, rep.coll_bytes, rep.coll_breakdown) == (
        2.0 * 64 * 32 * 16, 4.0 * (64 * 32 + 32 * 16 + 64 * 16), 0.0, {})
    assert rep.model_flops == 2.0 * cfg.active_params() * 8
    assert rep.hw is troof.HW and rep.bottleneck == "memory"


# ---------------- the op walk against the reference's HLO walk ----------------


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}


def _j_batch():
    return {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
            "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}


def _cfgs(w_bits):
    return (dataclasses.replace(j_smoke("smollm_360m"), w_bits=w_bits),
            dataclasses.replace(t_smoke("smollm_360m"), w_bits=w_bits))


@pytest.mark.parametrize("w_bits", [0, 2])
def test_prefill_step_dot_flops_equal_the_hlo_walk(w_bits):
    """The whole-prompt prefill step on the smoke config: the walk's dot
    flops (aten mm / bmm, plus flash_fwd's and packed_matmul's reports)
    equal the reference's compiled HLO's exactly: causal attention at 64
    tokens is one block there, so both count the whole score matrix."""
    jc, tc = _cfgs(w_bits)
    text = jax.jit(jsteps.make_prefill_step(jc)).lower(
        jlm.abstract_params(jc), _j_batch()).compile().as_text()
    want = hlo_analysis.analyze(text).dot_flops
    cost = oa.analyze(tsteps.make_prefill_step(tc), tlm.init_params(tc, 0, device="cpu"),
                      _batch(tc))
    assert cost.dot_flops == want
    assert cost.kernel_launches == {"flash_fwd": tc.n_layers,
                                    **({"packed_matmul": 3 * tc.n_layers} if w_bits else {})}
    assert cost.traffic_bytes > 0 and cost.collective_bytes == {}


def test_train_step_dot_flops_against_the_hlo_walk():
    """The train step (``--remat none``): the walk counts the reference's
    dots plus, per attention layer, what the two backward passes compute
    that the reference's one-pass backward does not: ``flash_bwd``'s dq and
    dk/dv passes each form QK^T and dO V^T (7 products of 2*BH*S*S*D
    against 5), and the reference forms delta = rowsum(dO * O) as a dot
    (2*BH*S*D) where the port's plain version multiplies and sums. The
    difference is exactly L * (2 * 2*BH*S*S*D - 2*BH*S*D)."""
    jc, tc = _cfgs(0)
    jp = jlm.abstract_params(jc)
    opt = JAdamW()
    text = jax.jit(jsteps.make_train_step(jc, opt, remat="none")).lower(
        jp, jax.eval_shape(opt.init, jp), _j_batch()).compile().as_text()
    want = hlo_analysis.analyze(text).dot_flops
    params = tlm.init_params(tc, 0, device="cpu", trainable=True)
    topt = TAdamW()
    cost = oa.analyze(tsteps.make_train_step(tc, topt, remat="none"), params,
                      topt.init(params), _batch(tc))
    bh, d, n_layers = B * tc.n_heads, tc.hd, tc.n_layers
    assert cost.dot_flops - want == n_layers * (2 * 2 * bh * S * S * d - 2 * bh * S * d)
    assert cost.kernel_launches == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), n_layers)
    top = oa.top_contributors(cost, "dot_flops", 3)
    assert [r[0] for r in top] == sorted((r[0] for r in top), reverse=True)


# ---------------- the conventions, by hand ----------------


def test_traffic_of_a_matmul_and_an_elementwise_op_is_hand_arithmetic():
    a, b = torch.ones(8, 16), torch.ones(16, 4, dtype=torch.float32)
    cost = oa.analyze(lambda: a @ b)
    assert (cost.dot_flops, cost.traffic_bytes) == (2.0 * 8 * 16 * 4, 4.0 * (128 + 64 + 32))
    x = torch.ones(8, 16, dtype=torch.bfloat16)
    cost = oa.analyze(lambda: x * 2.0)
    assert (cost.dot_flops, cost.traffic_bytes) == (0.0, 2.0 * 128 * 2)
    # a view moves nothing; the copy that makes it contiguous reads and writes it
    cost = oa.analyze(lambda: x.t().reshape(16, 8).contiguous())
    assert cost.traffic_bytes == 2.0 * 128 * 2
    # einsum: the bmm and the copy that lays its operand out; the views
    # around them (``_unsafe_view`` among them) move nothing
    a, b = torch.ones(8, 5, 4, 64), torch.ones(8, 640, 5, 64)
    cost = oa.analyze(lambda: torch.einsum("bhgd,bshd->bhgs", a, b))
    assert cost.traffic_bytes == 4.0 * (2 * b.numel() + a.numel() + b.numel() + 8 * 5 * 4 * 640)
    assert {op for op, _ in cost.rows} == {"clone", "bmm"}
    # a cast reads 2-byte and writes 4-byte elements; an exp is one transcendental each
    cost = oa.analyze(lambda: torch.exp(x.float()))
    assert cost.traffic_bytes == 128 * (2 + 4) + 128 * (4 + 4) and cost.transcendentals == 128


def test_gathers_and_scatters_count_the_rows_they_move():
    pool = torch.zeros(1000, 64)
    rows = torch.tensor([3, 7, 9])
    cost = oa.analyze(lambda: pool.index_select(0, rows))
    assert cost.traffic_bytes == 2 * 3 * 64 * 4 + 3 * 8
    cost = oa.analyze(lambda: pool[rows])
    assert cost.traffic_bytes == 2 * 3 * 64 * 4 + 3 * 8
    new = torch.ones(3, 64)

    def write():
        pool[rows] = new

    cost = oa.analyze(write)
    assert cost.traffic_bytes == 2 * 3 * 64 * 4 + 3 * 8
    cost = oa.analyze(lambda: pool.index_copy_(0, rows, new))
    assert cost.traffic_bytes == 2 * 3 * 64 * 4 + 3 * 8
    # copy_ and zero_ do not read what they overwrite
    cost = oa.analyze(lambda: pool[:3].copy_(new))
    assert cost.traffic_bytes == 2 * 3 * 64 * 4
    cost = oa.analyze(lambda: pool[:3].zero_())
    assert cost.traffic_bytes == 3 * 64 * 4


# ---------------- the kernels' reports ----------------


def _attn_inputs(gen, bh=6, bkv=2, sq=20, sk=24, d=16):
    q = torch.randn(bh, sq, d, generator=gen)
    k = torch.randn(bkv, sk, d, generator=gen)
    v = torch.randn(bkv, sk, d, generator=gen)
    return q, k, v


def test_each_kernel_reports_its_plain_version_s_dot_flops():
    """On the CPU each wrapper runs its plain version outside the walk;
    it reports the dot flops the walk counts for that plain version at
    the same shapes, one launch, and its operand + result bytes."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = _attn_inputs(gen)
    out, lse = ref.flash_fwd_ref(q, k, v)
    do = torch.randn(out.shape, generator=gen)
    dq, delta = ref.flash_bwd_dq_ref(q, k, v, out, lse, do)
    x = torch.randn(5, 64, generator=gen)
    carrier = torch.randint(0, 255, (16, 48), dtype=torch.uint8, generator=gen)
    scale = torch.rand(48, generator=gen)
    rows = torch.randn(64, 48, generator=gen)
    thr = torch.sort(torch.randn(48, 3, generator=gen), dim=-1).values
    signs = torch.ones(48)
    cases = [
        ("flash_fwd", fa.flash_fwd, ref.flash_fwd_ref, (q, k, v), {"window": 8}),
        ("flash_bwd_dq", fa.flash_bwd_dq, ref.flash_bwd_dq_ref, (q, k, v, out, lse, do), {}),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, ref.flash_bwd_dkv_ref,
         (q, k, v, do, lse, delta), {"causal": False}),
        ("packed_matmul", pm.packed_matmul, ref.packed_matmul_ref,
         (x, carrier, scale, 2, 64), {}),
        ("stream_matmul", ws.stream_matmul, ref.stream_matmul_ref,
         (x, carrier, scale, 2, 64), {}),
        ("stream_matmul", ws.stream_matmul, ref.stream_matmul_ref, (x, rows, None, 0, 64), {}),
        ("mvau", mv.mvau, lambda *a: ref.mvau_ref(a[0], a[1], a[2], a[3], 0, a[4], a[5]),
         (x, carrier, thr, signs, 2, 64), {}),
    ]
    for name, wrapper, plain, args, kw in cases:
        got = oa.analyze(wrapper, *args, **kw)
        want = oa.analyze(plain, *args, **kw)
        assert got.dot_flops == want.dot_flops > 0, name
        assert got.kernel_launches == {name: 1}, name
        res = wrapper(*args, **kw)
        res = res if isinstance(res, tuple) else (res,)
        assert got.traffic_bytes == sum(
            oa.tensor_bytes(t) for t in list(args) + list(res) if isinstance(t, torch.Tensor))


def test_a_step_reads_the_same_work_through_ops():
    """ops' public entry points reach the reporting wrappers: a flash
    attention's forward and backward, one report each pass."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 16, 4, 8, generator=gen, requires_grad=True)
    k = torch.randn(2, 16, 2, 8, generator=gen, requires_grad=True)
    v = torch.randn(2, 16, 2, 8, generator=gen, requires_grad=True)
    cost = oa.analyze(lambda: ops.flash_attention(q, k, v).sum().backward())
    assert cost.kernel_launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    unit = 2.0 * 8 * 16 * 16 * 8
    kernel_flops = sum(v[1] for (op, _), v in cost.rows.items() if op.startswith("kernel:"))
    assert kernel_flops == (2 + 3 + 4) * unit


def test_a_walk_counts_its_own_thread_only():
    """The walk is a dispatch mode on its own thread: a kernel wrapper that
    another thread calls while it runs is not counted into it, and the
    walk's own report is the same as with no other thread."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(5, 64, generator=gen)
    carrier = torch.randint(0, 255, (16, 48), dtype=torch.uint8, generator=gen)
    scale = torch.rand(48, generator=gen)
    args = (x, carrier, scale, 2, 64)

    def step():
        other = threading.Thread(target=pm.packed_matmul, args=args)
        other.start()
        other.join()
        return pm.packed_matmul(*args)

    cost = oa.analyze(step)
    alone = oa.analyze(pm.packed_matmul, *args)
    assert cost.kernel_launches == alone.kernel_launches == {"packed_matmul": 1}
    assert (cost.dot_flops, cost.traffic_bytes) == (alone.dot_flops, alone.traffic_bytes)
    assert dict(cost.rows) == dict(alone.rows)


# ---------------- collectives on a fake process group ----------------


def test_collectives_of_a_dtensor_redistribute_on_a_fake_process_group():
    """DTensor redistributes over a fake 8-rank (2 x 4) mesh on the CPU:
    each counted as its collective's kind, by the bytes entering it on
    one rank; none of them counts as memory traffic."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        x = torch.randn(16, 32)
        sharded = distribute_tensor(x, mesh, [Replicate(), Shard(0)])
        partial = DTensor.from_local(torch.randn(16, 32), mesh, [Replicate(), Partial()])
        local = 4 * 32 * 4  # one rank's (16 / 4) x 32 f32 shard
        for dt, placements, kind, nbytes in (
            (sharded, [Replicate(), Replicate()], "all-gather", local),
            (partial, [Replicate(), Replicate()], "all-reduce", 16 * 32 * 4),
            (partial, [Replicate(), Shard(0)], "reduce-scatter", 16 * 32 * 4),
        ):
            cost = oa.analyze(lambda: dt.redistribute(mesh, placements))
            assert cost.collective_bytes == {kind: nbytes}
            assert cost.total_collective_bytes == nbytes
            assert cost.traffic_bytes == 0 and cost.dot_flops == 0
            top = oa.top_contributors(cost, "collective", 5)
            assert len(top) == 1 and top[0][0] == nbytes
    finally:
        dist.destroy_process_group()
