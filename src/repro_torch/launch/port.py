"""Device-port planner: which device fits this model and traffic, at what
loss? Port of ``repro.launch.port``, flag for flag.

The paper's §V question, answered for both sides of the repo:

* **FPGA accelerator configs** (``cnv_w1a1`` ... ``rn50_w2a2``): sweep the
  ``core.resource_model.DEVICES`` catalog exactly as the reference does.
  Per device, report the baseline (one buffer per BRAM structure) against
  the FCMP-packed memory subsystem: does it fit, at what BRAM/LUT
  utilization, and at what throughput loss (``core.gals`` operating
  points; the achieved clocks of the paper's own design points are Table
  V's). The alternative port, 2x folding, re-folds the design (halving
  each layer's largest parallelism): it fits by shrinking *compute* and
  pays about half the throughput, the paper's Table V F2 row.

* **LM archs** (``smollm_360m`` ...): walk the ``GPU_TIERS`` ladder (the
  reference walks ``TPU_TIERS``) with the ``runtime.residency`` planner.
  Per rung, plan the packed model (``--quant``) and the dense one at the
  same on-chip budget, ``(1 - --reserve-frac)`` of the rung's
  ``onchip_bytes`` (its L2, the only on-chip store that outlives a
  launch), and compare decode throughput under a roofline step model over
  the rung's memory bandwidth and bf16 peak. FCMP packing cuts the
  streamed weight bytes 8-16x, so a port to a bandwidth-poorer card loses
  less throughput than serving dense weights. ``fits_hbm`` is the
  reference's rule: the padded FFN weight blocks under the rung's device
  memory.

Nothing here runs on a device: every rate is a data-sheet model, not a
measurement (the H100 rung's modelled tokens/s sits beside the measured
ones in ``chip_smoke.py``'s analysis phase). The residency plan covers
every family (an SSM arch has no FFN block to plan; an enc-dec arch plans
its decoder's FFN). ``--solver ga`` packs the LM sweep's plans with the
paper's GA too (``core.packing.pack_genetic``); the reference's LM sweep
passes the solver to a registry without the GA and raises a ``KeyError``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.port --arch rn50_w2a2
    PYTHONPATH=src python -m repro_torch.launch.port --arch smollm_360m --quant 1 \\
        --out port_report.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import ACCEL_IDS, canonical, get_accelerator, get_config
from repro_torch.core.buffers import Folding, buffer_set
from repro_torch.core.efficiency import baseline_report, device_utilization, report
from repro_torch.core.folding import mvau_luts
from repro_torch.core.gals import GalsOperatingPoint, folding_delta_fps
from repro_torch.core.packing import PackItem, pack_ffd, pack_genetic
from repro_torch.core.resource_model import DEVICES, GPU_TIERS, GpuChip
from repro_torch.runtime.residency import TrafficProfile, compile_residency_plan, fixed_hbm_bytes

# Achieved clocks per (kind, device): paper Table V hardware facts
# (f_compute, f_memory, f_compute_baseline). The w2a2 variants reuse the
# w1a2 closure numbers: the GALS memory subsystem, not the datapath
# precision, is what sets these clocks.
ACHIEVED_CLOCKS = {
    ("cnv", "zynq7020"): (100.0, 200.0, 100.0),
    ("cnv", "zynq7012s"): (100.0, 200.0, 100.0),
    ("rn50", "u250"): (183.0, 363.0, 203.0),
    ("rn50", "u280"): (138.0, 373.0, 203.0),
}
# F2 folding achieved clock vs its baseline (paper: 191 vs 195 MHz on U280)
FOLD2_CLOCKS = {("rn50", "u280"): (191.0, 195.0)}


def _clocks(kind: str, dev) -> tuple[float, float, float]:
    if (kind, dev.name) in ACHIEVED_CLOCKS:
        return ACHIEVED_CLOCKS[(kind, dev.name)]
    f_c = dev.f_compute_typ_mhz
    return f_c, min(2 * f_c, dev.f_mem_max_mhz), f_c


def _fold2(acc):
    """Re-fold the accelerator 2x: halve each layer's parallelism along
    its largest legal dimension (the paper's F2 alternative port)."""
    foldings = []
    for f in acc.folding.foldings:
        if f.pe > 1:
            foldings.append(Folding(f.pe // 2, f.simd))
        elif f.simd > 1:
            foldings.append(Folding(f.pe, f.simd // 2))
        else:
            foldings.append(f)
    bufs = buffer_set(acc.layers, foldings)
    luts = sum(mvau_luts(l, f) for l, f in zip(acc.layers, foldings))
    return bufs, luts


def accel_port_rows(name: str, solver: str = "ffd") -> list[dict]:
    """One row per FPGA device. The design is folded once for its native
    device and ported as it is (the paper's §V framing: the same
    accelerator, a smaller part); re-folding for the target is the
    "fold2" alternative it is compared against."""
    acc = get_accelerator(name)
    bufs = acc.buffers()
    items = [PackItem(b, region=r) for b, r in zip(bufs, acc.regions())]
    base = baseline_report("base", bufs)
    if solver == "ga":
        packing = pack_genetic(items, acc.ga)
    else:
        packing = pack_ffd(items, acc.ga.max_height)
    packed = report(f"P{acc.ga.max_height}", packing)
    compute_luts = acc.folding.luts
    fold_bufs, fold_luts = _fold2(acc)
    fold_brams = sum(b.blocks() for b in fold_bufs)
    rows = []
    for dev_name, dev in DEVICES.items():
        fit_b = device_utilization(dev, base.brams, compute_luts)
        fit_p = device_utilization(dev, packed.brams, compute_luts + packed.lut_overhead)
        f_c, f_m, f_base = _clocks(acc.kind, dev)
        op = GalsOperatingPoint(f_c, f_m, acc.ga.max_height, f_base)
        ff, ffb = FOLD2_CLOCKS.get((acc.kind, dev.name), (f_base, f_base))
        fit_f = device_utilization(dev, fold_brams, fold_luts)
        fold_delta = 1.0 - (1.0 - folding_delta_fps(2)) * ff / ffb
        rows.append({
            "bench": "port",
            "arch": name,
            "device": dev_name,
            "baseline_brams": base.brams,
            "baseline_fits": bool(fit_b["fits"]),
            "packed_brams": packed.brams,
            "packed_lut_overhead_k": round(packed.lut_overhead / 1000, 1),
            "packed_fits": bool(fit_p["fits"]),
            "packed_bram_pct": round(fit_p["bram_pct"], 1),
            "fcmp_delta_fps_pct": round(100 * op.delta_fps, 1),
            "fold2_brams": fold_brams,
            "fold2_fits": bool(fit_f["fits"]),
            "fold2_delta_fps_pct": round(100 * fold_delta, 1),
            "recommended": (
                "baseline" if fit_b["fits"]
                else "fcmp" if fit_p["fits"]
                and (not fit_f["fits"] or op.delta_fps <= fold_delta)
                else "fold2" if fit_f["fits"]
                else "none"
            ),
        })
    return rows


def _lm_step_model(cfg, chip: GpuChip, plan, traffic: TrafficProfile) -> dict:
    """Roofline decode-step model of one rung: compute against memory
    bytes (data-sheet rates)."""
    flop_t = 2.0 * cfg.active_params() * traffic.lanes / chip.peak_bf16_flops
    hbm_t = (plan.streamed_bytes_per_step + fixed_hbm_bytes(cfg, traffic)) / chip.hbm_bw
    step = max(flop_t, hbm_t)
    return {
        "step_us": step * 1e6,
        "tokens_per_s": traffic.lanes / step,
        "bound": "hbm" if hbm_t > flop_t else "compute",
    }


def lm_port_rows(
    name: str,
    quant: int = 1,
    lanes: int = 8,
    prompt_len: int = 512,
    gen_len: int = 128,
    reserve_frac: float = 0.5,
    tiers: dict[str, GpuChip] = GPU_TIERS,
    solver: str = "ffd",
) -> list[dict]:
    """One row per (rung of ``tiers``, variant): the packed model at
    ``quant`` bits (the families whose FFN packs) and the dense one. The
    columns are the reference's; ``vmem_budget_mib`` is the rung's
    on-chip budget (its L2 share). The residency plan packs with
    ``solver``: FFD, the reference's default, or the GA."""
    cfg = get_config(name)
    traffic = TrafficProfile(lanes=lanes, prompt_len=prompt_len, gen_len=gen_len)
    variants = {"dense": cfg}
    if quant and cfg.family in ("dense", "vlm", "encdec", "hybrid"):
        variants = {"fcmp_packed": dataclasses.replace(cfg, w_bits=quant), "dense": cfg}
    rows = []
    best_tput: dict[str, float] = {}
    for tier, chip in tiers.items():
        budget = int(chip.onchip_bytes * (1.0 - reserve_frac))
        for variant, vcfg in variants.items():
            plan = compile_residency_plan(vcfg, vmem_budget_bytes=budget, chip=chip,
                                          solver=solver)
            perf = _lm_step_model(vcfg, chip, plan, traffic)
            param_bytes = sum(b.padded_bytes(chip) for b in plan.blocks)
            rows.append({
                "bench": "port",
                "arch": name,
                "device": tier,
                "variant": variant,
                "fits_hbm": bool(param_bytes < chip.hbm_bytes),
                "vmem_budget_mib": round(budget / 2**20, 1),
                "resident_fraction": round(plan.resident_fraction, 3),
                "streamed_mib_per_step": round(plan.streamed_bytes_per_step / 2**20, 2),
                "stream_ahead": plan.stream_ahead,
                "bound": perf["bound"],
                "tokens_per_s": round(perf["tokens_per_s"], 1),
            })
            best_tput[variant] = max(best_tput.get(variant, 0.0), perf["tokens_per_s"])
    dense_tput = {r["device"]: r["tokens_per_s"] for r in rows if r["variant"] == "dense"}
    for r in rows:
        ref = best_tput[r["variant"]]
        r["delta_fps_pct"] = round(100 * (1.0 - r["tokens_per_s"] / ref), 1) if ref else 0.0
        # the §V cross-check per rung: packing against serving dense weights
        if r["variant"] == "fcmp_packed" and dense_tput.get(r["device"]):
            r["fcmp_vs_dense_speedup_pct"] = round(
                100 * (r["tokens_per_s"] / dense_tput[r["device"]] - 1.0), 1
            )
    return rows


def port_report(arch: str, **kw) -> list[dict]:
    """Rows for one arch or accelerator."""
    cand = canonical(arch)
    if cand in ACCEL_IDS:
        return accel_port_rows(cand, solver=kw.get("solver", "ffd"))
    return lm_port_rows(
        cand,
        quant=kw.get("quant", 1),
        lanes=kw.get("lanes", 8),
        prompt_len=kw.get("prompt_len", 512),
        gen_len=kw.get("gen_len", 128),
        reserve_frac=kw.get("reserve_frac", 0.5),
        solver=kw.get("solver", "ffd"),
    )


def _print_rows(rows: list[dict]) -> None:
    keys: list[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    print(",".join(keys))
    for r in rows:
        print(",".join(str(r.get(k, "")) for k in keys))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Which device fits a model and its traffic, at what throughput loss: "
        "the FPGA sweep over the paper's devices, or the LM sweep over a ladder of NVIDIA "
        "GPUs. Arithmetic only: the rates are a data-sheet model, not a measurement.")
    ap.add_argument("--arch", required=True, help="accelerator (cnv_w1a1 ...) or LM arch")
    ap.add_argument("--quant", type=int, default=1, choices=[0, 1, 2],
                    help="packed precision for the LM FCMP variant")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-len", type=int, default=128)
    ap.add_argument("--reserve-frac", type=float, default=0.5,
                    help="on-chip (L2) fraction reserved for activations")
    ap.add_argument("--solver", choices=["ffd", "ga"], default="ffd",
                    help="packing solver of the accelerator sweep and of the LM sweep's "
                         "residency plans")
    ap.add_argument("--out", default="", help="write the report rows as JSON")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        rows = port_report(
            args.arch,
            quant=args.quant,
            lanes=args.lanes,
            prompt_len=args.prompt_len,
            gen_len=args.gen_len,
            reserve_frac=args.reserve_frac,
            solver=args.solver,
        )
    except ValueError as e:
        print(f"[port] {e}")
        return 2
    _print_rows(rows)
    # the §V headline, where the row set exposes it: on a port target the
    # FCMP memory subsystem loses less throughput than 2x folding
    for r in rows:
        if "fold2_delta_fps_pct" in r and r["packed_fits"] and not r["baseline_fits"]:
            better = r["fcmp_delta_fps_pct"] < r["fold2_delta_fps_pct"]
            print(
                f"[port] {r['arch']} -> {r['device']}: FCMP loses "
                f"{r['fcmp_delta_fps_pct']}% vs folding "
                f"{r['fold2_delta_fps_pct']}% -> "
                f"{'FCMP wins (paper §V)' if better else 'folding wins'}"
            )
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "rows": rows}, f, indent=2)
        print(f"[port] wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
