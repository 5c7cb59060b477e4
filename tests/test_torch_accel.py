"""Port parity for the paper's FPGA accelerator models (CNV and ResNet-50
as MVAU layer sets): the port's ``configs.get_accelerator`` and its
``core`` copies against ``repro.configs`` / ``repro.core``. Everything is
pure Python, so the two packages must agree exactly."""

import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as jconf  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.configs as tconf  # noqa: E402
from repro_torch.core import buffers as tbuf  # noqa: E402
from repro_torch.core import dataflow as tdf  # noqa: E402
from repro_torch.core import efficiency as teff  # noqa: E402
from repro_torch.core import gals as tgals  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import resource_model as trm  # noqa: E402
from repro_torch.core import topologies as ttop  # noqa: E402

ACCEL_IDS = ["cnv_w1a1", "cnv_w2a2", "rn50_w1a2", "rn50_w2a2"]
# a small GA for ResNet-50's 52 buffers, as the reference's own tests keep it
SMALL_GA = dict(population=12, generations=6)


def _fields(objs):
    return [dataclasses.asdict(o) for o in objs]


def _items(mod, acc):
    return [mod.PackItem(b, r) for b, r in zip(acc.buffers(), acc.regions())]


def _buffers_as_port(jbufs):
    return [tbuf.WeightBuffer(**dataclasses.asdict(b)) for b in jbufs]


def test_registry_matches_reference():
    assert tconf.ACCEL_IDS == jconf.ACCEL_IDS == ACCEL_IDS
    for name in ACCEL_IDS:
        with pytest.raises(ValueError, match="accelerator"):
            tconf.canonical_arch(name)
        with pytest.raises(ValueError, match="accelerator"):
            tconf.get_config(name)
    with pytest.raises(ValueError):
        tconf.get_accelerator("smollm_360m")
    assert tconf.get_accelerator("cnv-w1a1").name == "cnv_w1a1"


@pytest.mark.parametrize("w_bits", [1, 2])
def test_layer_sets_match_reference(w_bits):
    assert _fields(ttop.cnv_layers(w_bits)) == _fields(jcore.cnv_layers(w_bits))
    for top in (False, True):
        assert _fields(ttop.resnet50_layers(w_bits, top)) == _fields(
            jcore.resnet50_layers(w_bits, top))
    layers = jcore.resnet50_layers(w_bits)
    for n_slr in (1, 3, 4):
        assert ttop.resblock_slr_map(ttop.resnet50_layers(w_bits), n_slr) == \
            jcore.resblock_slr_map(layers, n_slr)


@pytest.mark.parametrize("name", ACCEL_IDS)
def test_accelerator_folding_buffers_and_pipeline_match(name):
    ta, ja = tconf.get_accelerator(name), jconf.get_accelerator(name)
    assert (ta.name, ta.kind, ta.w_bits, ta.a_bits, ta.target_ii) == \
        (ja.name, ja.kind, ja.w_bits, ja.a_bits, ja.target_ii)
    assert dataclasses.asdict(ta.device) == dataclasses.asdict(ja.device)
    assert dataclasses.asdict(ta.ga) == dataclasses.asdict(ja.ga)
    assert _fields(ta.layers) == _fields(ja.layers)
    assert _fields(ta.folding.foldings) == _fields(ja.folding.foldings)
    assert (ta.folding.luts, ta.folding.brams) == (ja.folding.luts, ja.folding.brams)
    tb, jb = ta.buffers(), ja.buffers()
    assert _fields(tb) == _fields(jb)
    assert [b.blocks(trm.URAM) for b in tb] == [b.blocks(jcore.URAM) for b in jb]
    assert [b.efficiency() for b in tb] == [b.efficiency() for b in jb]
    assert ta.regions() == ja.regions()
    assert [tbuf.mvau_cycles(l, f) for l, f in zip(ta.layers, ta.folding.foldings)] == \
        [jcore.mvau_cycles(l, f) for l, f in zip(ja.layers, ja.folding.foldings)]
    for f_mhz in (ta.f_compute_mhz, 137.5):
        tm, jm = ta.folding.model(f_mhz), ja.folding.model(f_mhz)
        assert (tm.max_ii, tm.fps, tm.latency_s, tm.total_macs, tm.tops) == \
            (jm.max_ii, jm.fps, jm.latency_s, jm.total_macs, jm.tops)
        t2, j2 = tm.folded(2), jm.folded(2)
        assert _fields(t2.foldings) == _fields(j2.foldings) and t2.fps == j2.fps
        assert tdf.balance_report(tm) == jcore.balance_report(jm)
    assert [tbuf.kernel_efficiency_bound(k) for k in (1, 3, 5, 7)] == \
        [jcore.buffers.kernel_efficiency_bound(k) for k in (1, 3, 5, 7)]


@pytest.mark.parametrize("name", ACCEL_IDS)
def test_accelerator_packing_costs_and_reports_match(name):
    ta, ja = tconf.get_accelerator(name), jconf.get_accelerator(name)
    ti, ji = _items(tpack, ta), _items(jcore, ja)
    h = ta.ga.max_height
    tbase, jbase = tpack.baseline_packing(ti), jcore.baseline_packing(ji)
    tffd, jffd = tpack.pack_ffd(ti, h), jcore.pack_ffd(ji, h)
    params = ta.ga if ta.kind == "cnv" else dataclasses.replace(ta.ga, **SMALL_GA)
    tga = tpack.pack_genetic(ti, params)
    jga = jcore.pack_genetic(ji, jcore.GaParams(**dataclasses.asdict(params)))
    for tp, jp in ((tbase, jbase), (tffd, jffd), (tga, jga)):
        assert tp.bins == jp.bins  # bin for bin
        assert (tp.total_blocks, tp.efficiency, tp.heights, tp.odd_height_bins,
                tp.bin_widths_bits()) == (jp.total_blocks, jp.efficiency, jp.heights,
                                          jp.odd_height_bins, jp.bin_widths_bits())
        tp.validate(h)
        tr = teff.report("P", tp)
        jr = jcore.report("P", jp)
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        assert tr.row() == jr.row()
    tb = teff.baseline_report(ta.name, ta.buffers())
    jb = jcore.baseline_report(ja.name, ja.buffers())
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    assert tffd.total_blocks <= tbase.total_blocks
    for dev in trm.DEVICES:
        assert teff.device_utilization(trm.DEVICES[dev], tga.total_blocks, 1e4) == \
            jcore.device_utilization(jcore.DEVICES[dev], jga.total_blocks, 1e4)


def test_ga_params_and_devices_match():
    assert dataclasses.asdict(tpack.GA_PARAMS_CNV) == dataclasses.asdict(jcore.GA_PARAMS_CNV)
    assert dataclasses.asdict(tpack.GA_PARAMS_RN50) == dataclasses.asdict(jcore.GA_PARAMS_RN50)
    assert {k: dataclasses.asdict(v) for k, v in trm.DEVICES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcore.DEVICES.items()}
    assert {k: v.ocm_bits for k, v in trm.DEVICES.items()} == \
        {k: v.ocm_bits for k, v in jcore.DEVICES.items()}
    assert dataclasses.asdict(trm.URAM) == dataclasses.asdict(jcore.URAM)
    args = ([72, 36, 18], [3, 1, 4], 2, 36)
    assert trm.fcmp_lut_overhead(*args) == jcore.fcmp_lut_overhead(*args)


@pytest.mark.parametrize(
    "f_c,f_m,h_b,f_base",
    [(183.0, 363.0, 4, 195.0), (100.0, 200.0, 4, 100.0), (138.0, 373.0, 4, 195.0),
     (150.0, 225.0, 3, 160.0), (200.0, 250.0, 5, 200.0)],
)
def test_gals_operating_points_match(f_c, f_m, h_b, f_base):
    top = tgals.GalsOperatingPoint(f_c, f_m, h_b, f_base)
    jop = jcore.GalsOperatingPoint(f_c, f_m, h_b, f_base)
    assert (top.r_f, top.effective_rate_mhz, top.delta_fps, top.throughput_preserved) == \
        (jop.r_f, jop.effective_rate_mhz, jop.delta_fps, jop.throughput_preserved)
    jg = jcore.gals
    for r_f in (1.0, 1.5, 2.0, f_m / f_c):
        assert tgals.virtual_ports(r_f) == jg.virtual_ports(r_f)
        assert tgals.max_bin_height(r_f) == jg.max_bin_height(r_f)
        assert tgals.reads_per_compute_cycle(h_b, r_f) == jg.reads_per_compute_cycle(h_b, r_f)
    assert tgals.needs_odd_even_split(h_b) == jg.needs_odd_even_split(h_b)
    assert tgals.split_buffer_rate(h_b) == jg.split_buffer_rate(h_b)
    assert tgals.required_rf(h_b) == jg.required_rf(h_b)
    assert tgals.folding_delta_fps(h_b) == jg.folding_delta_fps(h_b)
