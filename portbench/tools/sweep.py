"""Find the knee of an open-loop cell: the highest arrival rate at which
the queue does not grow over a window. One engine is set up once; each
rate runs a window of its own on a fresh stream, then the engine drains.

    python3 portbench/tools/sweep.py --workload <an open-loop cell> \\
        --seconds 30 --rates 3 4 5 6 --out build/portbench/sweep.jsonl

For each rate it prints the requests due and completed in the window, the
queue left at its close, and the 95th percentile of TTFT in the window's
first and second halves: a queue that grows shows as a second half
slower than the first and a queue that does not empty.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np

T_START = time.monotonic()
HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness import model  # noqa: E402
from harness.cli import load_cell, power_limit  # noqa: E402
from harness.traffic import Mix  # noqa: E402
from harness.window import run_window  # noqa: E402


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    c = cell.config
    mix = Mix(cell.mix_name, cell.mix)
    weights = model.make_weights(c, args.seed, device)
    sched = model.build_engine(c, model.program_params(c, weights), mix, device)
    model.warm_up(sched, mix, [], args.seed, int(c["vocab_size"]))
    card = power_limit()
    for i, rate in enumerate(args.rates):
        p = copy.deepcopy(cell.mix)
        p["arrival"]["rate_per_s"] = rate
        stream = Mix(cell.mix_name, p).stream(args.seed + i, int(c["vocab_size"]))
        win = run_window(sched, stream, "open", args.seconds, ramp_s=float(p.get("ramp_s", 0)))
        mid = win.t_open + win.seconds / 2
        ttft = [(s.t_first - s.t_sent, s.t_first) for s in win.first_tokens]
        halves = [[t for t, at in ttft if (at < mid) == first] for first in (True, False)]
        row = {"rate": rate, "card": card, "due": win.attempted,
               "completed": len(win.completed), "queued_at_close": len(sched.queue),
               "tokens_per_s": win.emitted / win.seconds,
               "ttft_p95_ms_halves": [float(np.percentile(h, 95)) * 1e3 if h else None
                                      for h in halves],
               "late_s": win.late_s}
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        sched.run(max_rounds=10**6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
