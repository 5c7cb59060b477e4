"""A run of each cell on the card, as a check runs it: a new process from
the checkout's root, a short window, ``correct`` true and the result line
last. Skipped without a CUDA device."""

import json
import subprocess
import sys

import pytest
from conftest import HERE

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(cell, card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        "2147483747", "--seconds", "10", "--trace", "0"],
                       cwd=HERE.parent, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
