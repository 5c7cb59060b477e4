"""Port parity for the device-port planner (``launch/port.py``): the FPGA
sweep over the paper's devices, the LM sweep over a ladder of chips (the
reference's TPU ladder rebuilt as ``GpuChip`` records, then the port's own
``GPU_TIERS``), the residency planner's chip keyword, and ``core.vmem_plan``'s per-block plan, each against
``repro`` on the same inputs. All of it is arithmetic: the parity is
exact."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ACCEL_IDS  # noqa: E402
from repro.configs import get_accelerator as j_accel  # noqa: E402
from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import vmem_plan as jvp  # noqa: E402
from repro.core.resource_model import TPU_TIERS  # noqa: E402
from repro.launch import port as jport  # noqa: E402
from repro.runtime.residency import plan as jplan  # noqa: E402
from repro_torch.configs import get_accelerator as t_accel  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import vmem_plan as tvp  # noqa: E402
from repro_torch.core.resource_model import GPU_TIERS, H100_SXM, GpuChip  # noqa: E402
from repro_torch.launch import port as tport  # noqa: E402
from repro_torch.runtime.residency import plan as tplan  # noqa: E402

LM_ARCHS = ["smollm_360m", "llama3p2_1b", "zamba2_2p7b"]


def _gpu_chip(tpu) -> GpuChip:
    """A reference TPU tier as a ``GpuChip``: its VMEM as the on-chip
    budget, its (sublane, lane) tile as the granule, the same HBM and
    peak."""
    return GpuChip(name=tpu.name, sms=1, smem_per_sm_bytes=0, l2_bytes=tpu.vmem_bytes,
                   hbm_bytes=tpu.hbm_bytes, hbm_bw=tpu.hbm_bw,
                   peak_bf16_flops=tpu.peak_bf16_flops, tile_rows=tpu.sublane,
                   tile_row_bytes=tpu.lane)


TPU_LADDER = {tier: _gpu_chip(chip) for tier, chip in TPU_TIERS.items()}


# ---------------- the FPGA sweep ----------------


@pytest.mark.parametrize("arch", ACCEL_IDS)
def test_accel_port_rows_match_reference_ffd(arch):
    assert tport.accel_port_rows(arch) == jport.accel_port_rows(arch)


@pytest.mark.parametrize("arch", ["cnv_w1a1", "rn50_w2a2"])
def test_accel_port_rows_match_reference_ga(arch):
    """The GA packer (seeded as the reference's) gives the same bins, so
    the same rows."""
    assert tport.accel_port_rows(arch, solver="ga") == jport.accel_port_rows(arch, solver="ga")


@pytest.mark.parametrize("arch,target", [("cnv_w1a1", "zynq7012s"), ("rn50_w2a2", "u280")])
def test_port_reproduces_section_v_ordering(arch, target):
    """The paper's §V result on the port's rows (tests/test_residency.py's
    check): the smaller part cannot hold the baseline, FCMP makes it fit
    and loses less throughput than 2x folding."""
    r = {row["device"]: row for row in tport.accel_port_rows(arch)}[target]
    assert not r["baseline_fits"]
    assert r["packed_fits"]
    assert r["fcmp_delta_fps_pct"] < r["fold2_delta_fps_pct"]
    assert r["recommended"] == "fcmp"


def test_fold2_matches_reference():
    for arch in ("cnv_w2a2", "rn50_w1a2"):
        tb, tl = tport._fold2(t_accel(arch))
        jb, jl = jport._fold2(j_accel(arch))
        assert tl == jl
        assert [(b.name, b.width_bits, b.depth_words, b.w_bits) for b in tb] == [
            (b.name, b.width_bits, b.depth_words, b.w_bits) for b in jb]


# ---------------- the LM sweep ----------------


@pytest.mark.parametrize("quant", [0, 1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_port_rows_match_reference_on_its_ladder(arch, quant):
    """At full size, over the reference's TPU tiers rebuilt as GpuChips,
    the rows (plan arithmetic and the step model) equal the reference's,
    column for column."""
    got = tport.lm_port_rows(arch, quant=quant, tiers=TPU_LADDER)
    assert got == jport.lm_port_rows(arch, quant=quant)


def test_lm_port_rows_other_traffic_and_solver_match_reference():
    """Another traffic profile and reserve, at the sweep's solver (FFD,
    the reference's default)."""
    kw = dict(quant=2, lanes=32, prompt_len=2048, gen_len=256, reserve_frac=0.25)
    assert tport.lm_port_rows("llama3p2_1b", tiers=TPU_LADDER, **kw) == jport.lm_port_rows(
        "llama3p2_1b", solver="ffd", **kw)


def test_gpu_ladder_is_ordered_and_ends_at_the_h100():
    chips = list(GPU_TIERS.values())
    keys = [(c.hbm_bw, c.peak_bf16_flops) for c in chips]
    assert keys == sorted(keys)
    assert chips[-1] is H100_SXM and list(GPU_TIERS)[-1] == "h100_sxm"
    assert all(c.onchip_bytes == c.l2_bytes for c in chips)
    assert H100_SXM.onchip_bytes == 50 * 2**20


def test_port_lm_ladder_prefers_packing():
    """tests/test_residency.py's check on the GPU ladder: on every rung the
    packed model streams no more bytes and decodes no slower."""
    rows = tport.lm_port_rows("smollm_360m", quant=1, lanes=8)
    assert {r["device"] for r in rows} == set(GPU_TIERS)
    by = {(r["device"], r["variant"]): r for r in rows}
    for tier in GPU_TIERS:
        packed, dense = by[(tier, "fcmp_packed")], by[(tier, "dense")]
        assert packed["tokens_per_s"] >= dense["tokens_per_s"]
        assert packed["streamed_mib_per_step"] <= dense["streamed_mib_per_step"]
        assert packed["fcmp_vs_dense_speedup_pct"] >= 0


def test_internvl2_fits_one_h100_only_packed():
    """The paper's port on an LM: at 2 bits internvl2-76b's FFN blocks
    (~14.1 GB) fit the H100's 80 GB, in bf16 (~112.7 GB) they do not."""
    by = {(r["device"], r["variant"]): r
          for r in tport.lm_port_rows("internvl2_76b", quant=2)}
    assert by[("h100_sxm", "fcmp_packed")]["fits_hbm"]
    assert not by[("h100_sxm", "dense")]["fits_hbm"]
    blocks = tplan.weight_blocks(dataclasses.replace(t_full("internvl2_76b"), w_bits=2))
    assert 14.0e9 < sum(b.padded_bytes(H100_SXM) for b in blocks) < 14.2e9


def test_port_cli_prints_the_reference_accel_report(capsys, tmp_path):
    """``main`` prints the reference's CSV and §V headline lines, and
    writes the same JSON rows."""
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    assert tport.main(["--arch", "rn50_w2a2", "--out", str(out_t)]) == 0
    text_t = capsys.readouterr().out
    assert jport.main(["--arch", "rn50_w2a2", "--out", str(out_j)]) == 0
    text_j = capsys.readouterr().out
    assert text_t.replace(str(out_t), "OUT") == text_j.replace(str(out_j), "OUT")
    assert "FCMP wins (paper §V)" in text_t
    assert json.loads(out_t.read_text()) == json.loads(out_j.read_text())


def test_port_cli_lm_sweep_and_refusals(capsys):
    assert tport.main(["--arch", "smollm-360m", "--quant", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split(",")[:5] == ["bench", "arch", "device", "variant", "fits_hbm"]
    assert lines[0].endswith("delta_fps_pct,fcmp_vs_dense_speedup_pct")
    assert len(lines) == 1 + 2 * len(GPU_TIERS)
    assert tport.main(["--arch", "no_such_arch"]) == 2
    assert "unknown arch" in capsys.readouterr().out
    # the residency plan covers the pool's families: SSM has no FFN to plan
    assert tport.main(["--arch", "mamba2_1p3b"]) == 2
    assert "residency plan covers" in capsys.readouterr().out
    assert tport.main(["--arch", "smollm_360m", "--solver", "ga"]) == 2
    assert "packs with ffd, not 'ga'" in capsys.readouterr().out
    assert "data-sheet model, not a measurement" in tport.build_parser().format_help()


# ---------------- the planner's keywords ----------------


def _plan_view(plan) -> dict:
    s = plan.summary()
    return dict(
        bins=plan.bins, bin_tiles=plan.bin_tiles, resident=plan.resident,
        stream_ahead=plan.stream_ahead, read_weights=plan.read_weights,
        streamed=plan.streamed_bytes_per_step, ring=plan.ring_bytes,
        n_bins=s["n_bins"], resident_mib=s["resident_mib"],
        resident_fraction=s["resident_fraction"], vmem_budget_mib=s["vmem_budget_mib"],
        streamed_mib=s.get("streamed_mib_per_step", s.get("planned_streamed_mib_per_step")),
    )


@pytest.mark.parametrize("tier", list(TPU_TIERS))
@pytest.mark.parametrize("arch", ["smollm_360m", "zamba2_2p7b", "olmoe_1b_7b"])
def test_planner_keywords_match_reference(arch, tier):
    """``compile_residency_plan(chip=)`` on a TPU-figure chip gives the
    reference's plan at its other defaults (bins, tiles, resident set,
    ring depth, summary) at a third of the streamable tile bytes; the
    smoke configs at 2 bits."""
    jc = dataclasses.replace(j_smoke(arch), w_bits=2 if arch != "olmoe_1b_7b" else 0)
    tc = dataclasses.replace(t_smoke(arch), w_bits=jc.w_bits)
    chip = TPU_LADDER[tier]
    total = sum(b.padded_bytes(chip) for b in tplan.weight_blocks(tc))
    got = tplan.compile_residency_plan(tc, vmem_budget_bytes=total // 3, chip=chip)
    want = jplan.compile_residency_plan(jc, vmem_budget_bytes=total // 3, chip=TPU_TIERS[tier])
    assert got.chip is chip
    assert _plan_view(got) == _plan_view(want)


def test_planner_defaults_are_the_serve_path_s():
    """With no chip the plan is the one the serve path always had: FFD
    bins of 4 on the H100."""
    tc = dataclasses.replace(t_full("smollm_360m"), w_bits=2)
    base = tplan.compile_residency_plan(tc, vmem_budget_bytes=7 << 20)
    spelled = tplan.compile_residency_plan(tc, vmem_budget_bytes=7 << 20, chip=H100_SXM)
    assert base == spelled
    assert base.chip is H100_SXM and base.summary()["chip"] == "h100_sxm"


def test_plan_bytes_follow_the_chip_passed_in():
    """padded_bytes, the summary and the tile RAM use the plan's chip, not
    the module's: a 16-row granule doubles a 1-row carrier block's pad."""
    tc = dataclasses.replace(t_smoke("smollm_360m"), w_bits=2)
    tall = dataclasses.replace(H100_SXM, name="tall", tile_rows=16)
    a = tplan.compile_residency_plan(tc, vmem_budget_bytes=0)
    b = tplan.compile_residency_plan(tc, vmem_budget_bytes=0, chip=tall)
    assert b.summary()["chip"] == "tall"
    assert b.streamable_bytes_per_step == sum(
        w * blk.padded_bytes(tall) for blk, w in zip(b.blocks, b.read_weights))
    assert b.streamable_bytes_per_step >= a.streamable_bytes_per_step
    assert tvp.vmem_tile_ram(tall).capacity_bits == 16 * 128 * 8


# ---------------- core.vmem_plan ----------------


@pytest.mark.parametrize("budget_mib,reserve", [(0, 0.5), (1, 0.5), (8, 0.25), (64, 0.0)])
def test_plan_vmem_residency_matches_reference(budget_mib, reserve):
    tc = dataclasses.replace(t_full("smollm_360m"), w_bits=2)
    jc = dataclasses.replace(j_full("smollm_360m"), w_bits=2)
    got = tvp.plan_vmem_residency(tplan.weight_blocks(tc), budget_mib << 20, reserve)
    want = jvp.plan_vmem_residency(jplan.weight_blocks(jc), budget_mib << 20, reserve)
    assert got.resident == want.resident
    assert (got.resident_bytes, got.streamed_bytes, got.hbm_traffic_reduction) == (
        want.resident_bytes, want.streamed_bytes, want.hbm_traffic_reduction)


def test_blocks_from_buffers_matches_reference():
    tbufs, jbufs = t_accel("cnv_w2a2").buffers(), j_accel("cnv_w2a2").buffers()
    rows_of = {b.name: (b.depth_words, b.width_bits // max(1, b.w_bits)) for b in jbufs}
    got = tvp.blocks_from_buffers(tbufs, rows_of)
    want = jvp.blocks_from_buffers(jbufs, rows_of)
    assert [(b.name, b.rows, b.cols, b.bits_per_weight) for b in got] == [
        (b.name, b.rows, b.cols, b.bits_per_weight) for b in want]
    plan_t = tvp.plan_vmem_residency(got, 1 << 16)
    plan_j = jvp.plan_vmem_residency(want, 1 << 16)
    assert plan_t.resident == plan_j.resident and plan_t.streamed_bytes == plan_j.streamed_bytes
