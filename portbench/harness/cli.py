"""One run of one cell: set-up, the measured window, the check of what it
served, and the result line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Everything a cell needs is
found by name: the cell in ``BENCHMARK.json``, its configuration in the
file the manifest names, its mix in ``portbench/traffic/<mix>.json``, its
check's limits in ``portbench/cells/<cell>.json``, and each metric's reader
in ``portbench/metrics/<metric>.py``. With ``--trace 0`` the run reports the
cell's end-to-end metrics; with ``--trace 1`` its per-layer ones, read with
a profiler over part of the window.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names
PROFILE_S = 2.0  # the traced part: the window's last 2 s (its last quarter at most)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    mix_name: str
    mix: dict  # the traffic file
    limits: dict  # the cell's check limits (empty: none set)
    end_to_end: list[dict]
    per_layer: list[dict]
    here: Path = HERE  # the benchmark's folder, where the metrics' readers are


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """A cell of the manifest, with every file it names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "portbench"
    limits_file = here / "cells" / f"{name}.json"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        mix_name=w["traffic"],
        mix=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits_file.read_text()) if limits_file.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        here=here,
    )


def reader(metric: str, here: Path = HERE):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {metric!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    config: dict
    window: object  # harness.window.Window
    trace: object  # harness.trace.TraceSummary, or None
    setup_s: float


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False) -> dict:
    """Set up, measure, check; returns the result's parts."""
    import torch

    from harness import check, model
    from harness.traffic import Mix
    from harness.trace import breakdown, events_of, summarize
    from harness.window import Profiled, run_window

    c = cell.config
    mix = Mix(cell.mix_name, cell.mix)
    stamps = {"start": t_start, "imports": time.monotonic()}
    if device.type == "cuda":
        torch.zeros(1, device=device)
    stamps["cuda_init"] = time.monotonic()

    def stamp(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stamps[name] = time.monotonic()

    weights = model.make_weights(c, seed, device)
    stamp("weights")
    params = model.program_params(c, weights)
    stamp("pack")
    sched = model.build_engine(c, params, mix, device)
    stamp("engine")
    stream = mix.stream(seed, int(c["vocab_size"]))
    warm = model.warm_up(sched, mix, stream.documents, seed, int(c["vocab_size"]))
    stamp("warm_up")
    profiled = None
    if trace:
        length = min(PROFILE_S, seconds / 4)
        profiled = Profiled(seconds - length, length)
        profiled.warm()
    win = run_window(sched, stream, mix.loop, seconds, ramp_s=mix.ramp_s, profiled=profiled)
    setup_s = win.t_open - t_start
    stamps["clients"] = win.t_open
    names = list(stamps)
    warm["setup_phases_s"] = {b: stamps[b] - stamps[a] for a, b in zip(names, names[1:])}
    if win.graphs_in_window:
        raise RuntimeError(f"{win.graphs_in_window} graphs were captured inside the window: "
                           "warm-up missed a shape the mix sends")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = None
    if profiled is not None and profiled.state == "done":
        summary = summarize(events_of(profiled.prof))
        profiled.prof = None
    finished = [(s.rid, sched.requests[s.rid].prompt.copy(), list(sched.requests[s.rid].output))
                for s in win.completed]
    del sched, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check_cfg = c.get("check", {})
    picked = check.sample(finished, seed, int(check_cfg.get("min_tokens", 512)),
                          int(check_cfg.get("max_requests", 12)))
    t_check = time.monotonic()
    gaps = check.served_gaps(c, weights, picked, device, control=control)
    gaps["check_s"] = time.monotonic() - t_check
    run = Run(c, win, summary, setup_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.here)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"window": win, "trace": summary, "metrics": metrics, "peak": peak,
            "gaps": gaps, "warm": warm, "setup_s": setup_s,
            "breakdown": breakdown(summary) if summary is not None else None}


def verdict(cell: Cell, gaps: dict) -> tuple[bool, dict]:
    """Whether the run is correct, and each number compared beside its
    limit. A cell with no limit set is never correct."""
    lim = cell.limits
    checks = {}
    if "max_logit_gap" in lim:
        checks["max_logit_gap"] = {"value": gaps["max_logit_gap"],
                                   "limit": lim["max_logit_gap"]["limit"], "passes": "value <= limit"}
    checks["tokens_compared"] = {"value": gaps["tokens_compared"],
                                 "limit": lim.get("tokens_compared", {}).get("min", 1),
                                 "passes": "value >= limit"}
    ok = "max_logit_gap" in checks and (
        checks["max_logit_gap"]["value"] <= checks["max_logit_gap"]["limit"]
        and math.isfinite(checks["max_logit_gap"]["value"]))
    ok = ok and checks["tokens_compared"]["value"] >= checks["tokens_compared"]["limit"]
    return ok, checks


def result_line(cell: Cell, out: dict, trace: bool, kind: str, card: str) -> dict:
    """The run's result line, its checks last. ``info`` adds what a reader
    of the line wants beside the metrics: the request tails in every cell,
    the counts behind them, and the set-up's phases."""
    from harness import readings

    win = out["window"]
    ok, checks = verdict(cell, out["gaps"])
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(out["peak"]), "card": card}
    if trace:
        t = out["trace"]
        dev["busy_s"] = t.busy_ns / 1e9 if t is not None else 0.0
        dev["window_s"] = t.window_ns / 1e9 if t is not None else 0.0
    result = {"correct": ok, "attempted": win.attempted, "failed": win.failed,
              "metrics": out["metrics"], "device": dev}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["info"] = {"window_s": win.seconds, "completed": len(win.completed),
                      "ttft_p95_ms": readings.ttft_p95_ms(win),
                      "tpot_p95_ms": readings.tpot_p95_ms(win),
                      "tpot_top": readings.tpot_top(win),
                      "first_tokens": len(win.first_tokens), "emitted": win.emitted,
                      "late_s": win.late_s, "check_s": out["gaps"]["check_s"],
                      "requests_compared": out["gaps"]["requests_compared"],
                      "graphs": out["warm"]["graphs"],
                      "setup_phases_s": out["warm"]["setup_phases_s"]}
    result["checks"] = checks
    return result


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    card = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}; the benchmark measures the "
              "port alone", file=sys.stderr)
        return 4
    result = result_line(cell, out, bool(args.trace), torch.cuda.get_device_name(0), card)
    sys.stdout.flush()
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']} limit {chk['limit']} ({chk['passes']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
