"""The result line's keys, as a check of the benchmark reads them, from a whole run on
the CPU at a tiny size."""

import json

import pytest
import torch
from conftest import tiny_cell

from harness.cli import result_line, run_cell


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace):
    cell = tiny_cell("smollm-360m-2bit.chat")
    cell.limits = {"max_logit_gap": {"limit": 1.0}}
    out = run_cell(cell, 11, 1.5, bool(trace), torch.device("cpu"), 0.0)
    line = json.loads(json.dumps(result_line(cell, out, bool(trace), "cpu test", "none")))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        # the CPU has no device trace: the device's readers find nothing
        assert set(line["metrics"]) == set(want) - {"device_idle_pct", "packed_matmul.gemv_roofline"}
    else:
        assert set(line["metrics"]) == set(want)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or name == "prefix_hit_pct"
    assert all({"value", "limit"} <= set(c) for c in line["checks"].values())


def test_profile_starts_where_a_round_outlasts_it(monkeypatch):
    """A traced run whose rounds outlast the profiled part (the MoE cell's
    rounds take seconds) still profiles one: the profiler starts a round
    early, not at the first round past its start."""
    import time

    import repro_torch.runtime.scheduler as scheduler_mod

    cell = tiny_cell("smollm-360m-2bit.chat")
    cell.limits = {"max_logit_gap": {"limit": 1.0}}
    real = scheduler_mod.Scheduler.round
    window = [False]

    def slow_round(self, *a, **k):
        out = real(self, *a, **k)
        if window[0]:
            time.sleep(1.2)  # the profile is the window's last 0.5 s of 2
        return out
    monkeypatch.setattr(scheduler_mod.Scheduler, "round", slow_round)

    import harness.window as window_mod
    real_tick = window_mod.Profiled.tick

    def tick(self, *a, **k):
        window[0] = True  # the window's rounds are slow; set-up's stay fast
        return real_tick(self, *a, **k)
    monkeypatch.setattr(window_mod.Profiled, "tick", tick)
    out = run_cell(cell, 13, 2.0, True, torch.device("cpu"), 0.0)
    # the profiler's start inside the window (its stop comes at the close;
    # the CPU has no device trace to summarise)
    assert len(out["window"].pauses) == 1
