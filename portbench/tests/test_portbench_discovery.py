"""A configuration, a traffic mix, a cell and a per-layer metric are added
with new files and new manifest entries alone: no file of the harness is
edited."""

import json
import shutil

import torch
from conftest import HERE, TINY

from harness.cli import load_cell, reader, run_cell


def test_new_files_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    here = root / "portbench"
    conf = json.loads((here / "configs" / "smollm-360m-2bit.json").read_text())
    conf.update(TINY, name="tiny-dense")
    conf["engine"]["lanes"] = 2
    (here / "configs" / "tiny-dense.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic" / "chat.json").read_text())
    mix.update(prompt={"dist": "uniform", "min": 20, "max": 40},
               output={"dist": "uniform", "min": 4, "max": 8})
    (here / "traffic" / "short-chat.json").write_text(json.dumps(mix))
    (here / "metrics" / "completed_requests.py").write_text(
        "def read(run):\n    return float(len(run.window.completed))\n")
    (here / "cells" / "tiny-dense.short-chat.json").write_text(
        json.dumps({"max_logit_gap": {"limit": 1.0}}))
    bench["configs"].append({"name": "tiny-dense", "source": "test", "reduced": [],
                             "file": "portbench/configs/tiny-dense.json", "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.short-chat", "config": "tiny-dense",
                               "traffic": "short-chat", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "completed_requests", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "scheduler",
                               "moves": "tokens_per_s", "workloads": ["tiny-dense.short-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("tiny-dense.short-chat", root=root)
    assert cell.config["name"] == "tiny-dense" and cell.mix["prompt"]["max"] == 40
    assert [m["name"] for m in cell.per_layer][-1] == "completed_requests"
    assert reader("completed_requests", here) is not None
    out = run_cell(cell, 7, 1.0, True, torch.device("cpu"), 0.0)
    assert out["metrics"]["completed_requests"]["value"] >= 1
    assert "packed_matmul.gemv_roofline" not in out["metrics"]  # listed for other cells
