"""Port parity for budgeted decode: the packing solvers, the residency plan,
the plain version of ``stream_matmul``, the budgeted decode step and
budgeted serving, each against ``repro`` on the same inputs, plus the
``--vmem-budget`` serve entry point on the CPU."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import vmem_plan as jvp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import weight_stream as jws  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.residency import plan as jplan  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import vmem_plan as tvp  # noqa: E402
from repro_torch.core.resource_model import H100_SXM  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import weight_stream as tws  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.residency import executor as texec  # noqa: E402
from repro_torch.runtime.residency import plan as tplan  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402

# the reference's decode-step parity tolerance (tests/test_torch_lm.py)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(size, w_bits):
    jc = j_full("smollm_360m") if size == "full" else j_smoke("smollm_360m")
    tc = t_full("smollm_360m") if size == "full" else t_smoke("smollm_360m")
    return dataclasses.replace(jc, w_bits=w_bits), dataclasses.replace(tc, w_bits=w_bits)


# ---------------- (a) packing solvers ----------------

GA = dict(max_height=4, population=12, generations=6, seed=0)


def _solve(mod, vp, plan_mod, cfg, solver):
    blocks = plan_mod.weight_blocks(cfg)
    items = [
        vp.block_item(b, region=plan_mod._region_of(b.name)) for b in blocks
    ]
    ram = vp.vmem_tile_ram()
    if solver == "genetic":
        return mod.pack_genetic(items, mod.GaParams(**GA), ram)
    return mod.SOLVERS[solver](items, 4, ram)


@pytest.mark.parametrize("solver", ["ffd", "anneal", "genetic"])
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_packing_solvers_match_reference(solver, size, w_bits):
    jc, tc = _cfgs(size, w_bits)
    want = _solve(jpack, jvp, jplan, jc, solver)
    got = _solve(tpack, tvp, tplan, tc, solver)
    assert [(dataclasses.astuple(it.buffer), it.region) for it in got.items] == [
        (dataclasses.astuple(it.buffer), it.region) for it in want.items
    ]
    assert got.bins == want.bins
    assert got.total_blocks == want.total_blocks
    got.validate(4)


def test_tile_ram_matches_h100_granule():
    """blocks_for on the tile primitive == H100_SXM.tile_blocks_for, and a
    block's padded bytes are its tile count times 8 x 128 B."""
    ram = tvp.vmem_tile_ram(H100_SXM)
    for rows, cols, bits in [(128, 256, 1), (96, 130, 2), (7, 7, 16), (960, 2560, 2)]:
        carrier_rows = -(-rows * bits // 8)
        tiles = H100_SXM.tile_blocks_for(carrier_rows, cols)
        assert ram.blocks_for(cols * 8, carrier_rows) == tiles
        assert tvp.WeightBlock("b", rows, cols, bits).padded_bytes() == tiles * 1024


# ---------------- (b) residency plan ----------------


@pytest.mark.parametrize("w_bits", [0, 1, 2])
@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5, 1.0])
def test_residency_plan_matches_reference(w_bits, frac):
    jc, tc = _cfgs("smoke", w_bits)
    total = sum(b.padded_bytes() for b in tplan.weight_blocks(tc))
    budget = int(total * frac)
    want = jplan.compile_residency_plan(
        jc, vmem_budget_bytes=budget,
        traffic=jplan.TrafficProfile(lanes=2, prompt_len=4, gen_len=4),
    )
    got = tplan.compile_residency_plan(tc, vmem_budget_bytes=budget)
    assert got.bins == want.bins
    assert got.bin_tiles == want.bin_tiles
    assert got.resident == want.resident
    assert got.stream_ahead == want.stream_ahead
    assert got.layer_stream_mask(tc) == want.layer_stream_mask(jc)
    assert got.streamed_bytes_per_step == want.streamed_bytes_per_step
    assert got.streamable_bytes_per_step == want.streamable_bytes_per_step
    s_got, s_want = got.summary(), want.summary()
    assert s_got.pop("chip") == "h100_sxm"
    s_want.pop("chip")
    # the port labels the streamed figures as plan arithmetic
    assert s_got.pop("planned_streamed_mib_per_step") == s_want.pop("streamed_mib_per_step")
    assert s_got.pop("planned_stream_fraction") == round(
        want.streamed_bytes_per_step / max(1.0, want.streamable_bytes_per_step), 4
    )
    s_want.pop("hbm_traffic_reduction")
    assert s_got == s_want


@pytest.mark.parametrize("w_bits,depth", [(0, 2), (1, 8), (2, 4)])
def test_stream_ahead_depth_on_the_full_config(w_bits, depth):
    """bf16 full config: dense -> 2, 2-bit -> 4, 1-bit -> 8, as the
    reference computes it."""
    jc, tc = _cfgs("full", w_bits)
    assert tplan.stream_ahead_depth(tc) == jplan.stream_ahead_depth(jc) == depth


# ---------------- (c) plain stream_matmul ----------------


def _stream_case(rng, m, k, n, bits):
    x = rng.normal(size=(m, k)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    if bits == 0:
        return x, rng.normal(size=(k, n)).astype(np.float32), scale
    vals = rng.integers(-1, 2, size=(k, n)).astype(np.float32)
    if bits == 1:
        vals = np.sign(vals + 0.5)
    w = tops.pack_weights(torch.from_numpy(vals), bits).numpy()
    return x, w, scale


@pytest.mark.parametrize("bits,depth", [(0, 2), (1, 2), (2, 4), (0, 3)])
def test_stream_matmul_plain_matches_pallas_interpret(bits, depth):
    rng = np.random.default_rng(bits * 10 + depth)
    m, k, n = 8, 512, 256
    x, w, scale = _stream_case(rng, m, k, n, bits)
    want = jws.stream_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), bits=bits, k=k,
        bn=128, ck=128, stream_depth=depth, interpret=True,
    )
    got = tops.stream_matmul(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        bits=bits, k=k, stream_depth=depth,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [0, 1, 2])
def test_stream_matmul_ragged_matches_reference_ops(bits):
    """K=100 (not a multiple of 8 nor of a ring stage) and N=70, batched;
    the port pads nothing: a 1-bit carrier's last row holds 4 padding
    codes that must contribute nothing."""
    rng = np.random.default_rng(3 + bits)
    x, w, scale = _stream_case(rng, 6, 100, 70, bits)
    x = x.reshape(2, 3, 100)
    sc = None if bits == 0 else scale
    want = jops.stream_matmul(
        jnp.asarray(x), jnp.asarray(w), None if sc is None else jnp.asarray(sc),
        bits=bits, k=100,
    )
    got = tops.stream_matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        None if sc is None else torch.from_numpy(sc), bits=bits, k=100,
    )
    assert tuple(got.shape) == (2, 3, 70)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_stream_matmul_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 16))
    carrier = torch.zeros((4, 5), dtype=torch.uint8)
    with pytest.raises(ValueError):  # ring of one stage
        tws.stream_matmul(x, carrier, None, 2, 16, stream_depth=1)
    with pytest.raises(ValueError):  # deeper than the kernel dispatches
        tws.stream_matmul(x, carrier, None, 2, 16, stream_depth=9)
    with pytest.raises(ValueError):  # 4-bit is not a streamed width
        tws.stream_matmul(x, carrier, None, 4, 16)
    with pytest.raises(ValueError):  # carrier rows != ceil(K*bits/8)
        tws.stream_matmul(x, carrier, None, 1, 16)
    with pytest.raises(ValueError):  # dense rows must be float
        tws.stream_matmul(x, torch.zeros((16, 5), dtype=torch.uint8), None, 0, 16)
    with pytest.raises(ValueError):  # scale of the wrong width
        tws.stream_matmul(x, carrier, torch.ones(4), 2, 16)


@pytest.mark.parametrize(
    "m,k,n,bits",
    [(8, 960, 2560, 2), (8, 2560, 960, 2), (8, 960, 2560, 1), (8, 2560, 960, 0),
     (16, 960, 2560, 0), (40, 100, 70, 1), (1, 8192, 64, 1), (8, 2560, 960, 1),
     (20, 2560, 960, 2), (8, 5000, 32 * 264, 2)],
)
def test_split_plan_covers_every_stage_once(m, k, n, bits):
    """The splits cover K once, each a whole number of carrier rows and
    16-deep slabs, and fit one portable cluster; the ring stays within its
    shared memory; at the decode shapes the grid covers the H100's SMs and
    a split's K range fits ``stream_depth`` stages, so all of it is in
    flight at once (a longer range, 5000 unsplit, cycles the ring). The
    one exception is f32 rows against f32 x, which decode never runs: 512
    K values of both would take 213 KB of ring at depth 2."""
    splits, kps = tws.split_plan(m, k, n, H100_SXM.sms)
    per = 8 // bits if bits else 1
    assert kps % tws.BK == 0 and kps % per == 0
    assert (splits - 1) * kps < k <= splits * kps
    assert 1 <= splits <= 8
    decode = m <= 16 and (k, n) in ((960, 2560), (2560, 960))
    if decode:
        assert splits * -(-n // tws.BN) * -(-m // tws.MT) >= H100_SXM.sms
    depth = tplan.stream_ahead_depth(_cfgs("full", bits)[1])
    for x_size in (2, 4):
        for w_size in (1,) if bits else (2, 4):
            sk = tws.stage_len(kps, depth, bits, w_size, x_size)
            assert sk % tws.BK == 0
            assert depth * tws.slot_bytes(sk, bits, w_size, x_size) <= tws.RING_MAX
            stages = -(-min(kps, k) // sk)
            if decode and (w_size, x_size) != (4, 4):
                assert stages <= depth
            if k == 5000:
                assert stages > depth


def test_build_all_covers_every_kernel_source():
    assert _build.kernel_names() == (
        "flash_bwd", "flash_fwd", "mvau", "packed_matmul", "weight_stream"
    )


# ---------------- (d) budgeted decode step ----------------


@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_budgeted_decode_step_matches_reference(w_bits):
    jc, tc = _cfgs("smoke", w_bits)
    jp = jlm.init_params(jc, jax.random.key(w_bits))
    params = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(30 + w_bits)
    shape = (jc.n_layers, 40, jc.n_kv, jc.hd)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    row_table = np.zeros((3, 12), np.int32)
    row_table[0, :8] = np.arange(4, 12)
    row_table[1, :12] = np.arange(12, 24)
    row_table[2, :4] = np.arange(30, 34)
    lengths = np.array([5, 11, 0], np.int32)
    token = np.array([[3], [100], [511]], np.int32)
    mask = (True, False)  # layer 0 streamed, layer 1 resident
    depth = tplan.stream_ahead_depth(tc)
    lg, jk, _ = jlm.decode_step_paged(
        jp, jc, jnp.asarray(token), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(row_table), jnp.asarray(lengths),
        stream_mask=jnp.asarray(mask), stream_depth=depth,
    )
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tlg, _, _ = tlm.decode_step_paged(
        params, tc, torch.from_numpy(token), tk, tv, torch.from_numpy(row_table),
        torch.from_numpy(lengths), stream_mask=mask, stream_depth=depth,
    )
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL, atol=ATOL)
    # and the port's own unbudgeted step gives the same logits bit for bit
    ulg, _, _ = tlm.decode_step_paged(
        params, tc, torch.from_numpy(token), torch.from_numpy(pk.copy()),
        torch.from_numpy(pv.copy()), torch.from_numpy(row_table),
        torch.from_numpy(lengths),
    )
    assert torch.equal(ulg, tlg)
    with pytest.raises(ValueError, match="flags"):
        tlm.decode_step_paged(
            params, tc, torch.from_numpy(token), tk, tv,
            torch.from_numpy(row_table), torch.from_numpy(lengths),
            stream_mask=(True,),
        )


# ---------------- (e) budgeted serving ----------------

SLOTS, MAX_LEN, BLOCK, GEN = 2, 20, 4, 5
PROMPT_LENS = (4, 9, 6)


def _serve(sched_cls, pool, cfg, params, sampling, plan):
    sched = sched_cls(
        cfg, params, pool, slots=SLOTS, max_len=MAX_LEN, sampling=sampling,
        residency=plan,
    )
    rng = np.random.default_rng(5)
    for p in PROMPT_LENS:
        sched.submit(rng.integers(0, cfg.vocab, size=p).astype(np.int32), GEN)
    sched.run()
    return sched.outputs()


@pytest.mark.parametrize(
    "sampling", [dict(), dict(temperature=0.9, top_k=20, seed=7)],
    ids=["greedy", "seeded"],
)
@pytest.mark.parametrize("w_bits", [0, 1, 2])
def test_budgeted_serving_is_token_identical(w_bits, sampling):
    jc, tc = _cfgs("smoke", w_bits)
    jp = jlm.init_params(jc, jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    half = sum(b.padded_bytes() for b in tplan.weight_blocks(tc)) // 2
    tplan_ = tplan.compile_residency_plan(tc, vmem_budget_bytes=half)
    jplan_ = jplan.compile_residency_plan(
        jc, vmem_budget_bytes=half,
        traffic=jplan.TrafficProfile(lanes=SLOTS, prompt_len=max(PROMPT_LENS), gen_len=GEN),
    )
    assert tplan_.layer_stream_mask(tc) == (False, True)  # one pinned, one streamed

    def tpool():
        return TPool.for_slots(tc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK,
                               device="cpu")

    sp_t, sp_j = tlm.SamplingParams(**sampling), jlm.SamplingParams(**sampling)
    budgeted = _serve(TSched, tpool(), tc, tp, sp_t, tplan_)
    unbudgeted = _serve(TSched, tpool(), tc, tp, sp_t, None)
    reference = _serve(
        JSched, JPool.for_slots(jc, slots=SLOTS, max_len=MAX_LEN, block_tokens=BLOCK),
        jc, jp, sp_j, jplan_,
    )
    assert [len(v) for v in budgeted.values()] == [GEN] * len(PROMPT_LENS)
    assert budgeted == unbudgeted == reference


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_residency_plan_covers_the_ported_family_only(family):
    """Neither family runs budgeted decode (as in the reference). SSM is
    not ported and has no FFN: planning for it raises instead of planning
    the dense layer blocks. Hybrid's plan lists its shared block's three
    mats, each read once a shared-block application, as the reference's
    does (its blocks and the weights: tests/test_torch_hybrid.py; MoE's
    expert blocks: tests/test_torch_moe.py)."""
    _, tc = _cfgs("smoke", 2)
    assert texec.supports_budgeted_decode(tc)
    other = dataclasses.replace(tc, family=family, hybrid_attn_every=1)
    assert not texec.supports_budgeted_decode(other)
    if family == "ssm":
        with pytest.raises(ValueError, match=family):
            tplan.compile_residency_plan(other, vmem_budget_bytes=0)
        return
    plan = tplan.compile_residency_plan(other, vmem_budget_bytes=0)
    assert [b.name for b in plan.blocks] == ["shared.w1", "shared.w3", "shared.w2"]
    assert plan.read_weights == (float(other.n_layers),) * 3


# ---------------- the serve entry point ----------------

SERVE_ARGS = ["--smoke", "--device", "cpu", "--quant", "2", "--requests", "3",
              "--batch", "2", "--prompt-len", "6", "--gen-len", "4", "--max-len", "16"]


def test_serve_cli_vmem_budget_prints_the_plan(capsys):
    _, tc = _cfgs("smoke", 2)
    half_mib = sum(b.padded_bytes() for b in tplan.weight_blocks(tc)) / 2 / 2**20
    assert serve.main(SERVE_ARGS + ["--vmem-budget", str(half_mib)]) == 0
    out = capsys.readouterr().out
    assert "[serve/residency] 3/6 weight blocks resident" in out
    assert "stream-ahead depth 8 (R_F); plan arithmetic, not measured" in out
    metrics = json.loads(
        next(l for l in out.splitlines() if l.startswith("[serve/metrics] ")).split(" ", 1)[1]
    )
    plan = tplan.compile_residency_plan(tc, vmem_budget_bytes=int(half_mib * 2**20))
    assert metrics["residency"] == plan.summary()
    assert metrics["residency"]["planned_stream_fraction"] == 0.5
    # the CPU launches no kernel: every counter is there and reads 0
    assert metrics["kernel_launches"] == dict.fromkeys(
        ["packed_matmul", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "stream_matmul",
         "mvau"], 0
    )
    assert metrics["generated_tokens"] == 12


def test_serve_cli_without_budget_reports_no_plan(capsys):
    assert serve.main(SERVE_ARGS) == 0
    out = capsys.readouterr().out
    assert "[serve/residency]" not in out
    assert '"residency": null' in out


def test_budget_plan_rejects_an_unsupported_family():
    _, tc = _cfgs("smoke", 0)
    args = serve.build_parser().parse_args(["--vmem-budget", "1"])
    with pytest.raises(ValueError, match="streamable-FFN"):
        serve.build_residency_plan(dataclasses.replace(tc, family="ssm"), args)


def test_required_rf_matches_reference():
    from repro.core import gals as jgals
    from repro_torch.core import gals as tgals

    assert tgals.N_PORTS == jgals.N_PORTS
    assert [tgals.required_rf(h) for h in range(1, 9)] == [
        jgals.required_rf(h) for h in range(1, 9)
    ]
    with pytest.raises(ValueError):
        tgals.required_rf(0)
