"""The control's and the program's readings of a cell, on several seeds in
one process: each seed a whole run of the cell (set-up, a window at the
cell's load, the check), the check run twice over the same served tokens:
by the float32 reference, and by the float8 control (``reference/lm.py``,
``mode="fp8"``), whose first choice at each position is read against the
reference.

    python3 portbench/tools/control.py --workload smollm-360m-2bit.chat \\
        --seconds 15 --seeds 11 12 13 --out build/portbench/control.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.monotonic()
HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness.cli import load_cell, power_limit, run_cell  # noqa: E402


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    card = power_limit()
    for seed in args.seeds:
        t0 = time.monotonic()
        out = run_cell(cell, seed, args.seconds, False, device, t0, control=True)
        row = {"cell": cell.name, "seed": seed, "card": card, **out["gaps"],
               "completed": len(out["window"].completed),
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
