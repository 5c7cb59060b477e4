"""Run cells of the benchmark one after another, each run in a process of
its own as a check runs them, and keep every result line.

    python3 portbench/tools/series.py --out build/portbench/series.jsonl \\
        --run smollm-360m-2bit.chat:1001:30:0 --run smollm-360m-2bit.chat:1002:30:1

Each ``--run`` is ``cell:seed:seconds:trace``. One JSON line a run goes to
``--out`` (the result line, the exit code, the wall seconds and the end of
standard error); a short line a run goes to standard output. With
``--stop``, the series ends at the first run that fails or is not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_one(cell: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.monotonic()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                           env=dict(os.environ))
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    wall = time.monotonic() - t0
    result = None
    lines = out.strip().splitlines()
    if lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace, "rc": rc,
            "wall_s": wall, "result": result, "stderr_tail": err[-3000:]}


def short(r: dict) -> str:
    res = r["result"] or {}
    m = {k: round(v["value"], 4) for k, v in res.get("metrics", {}).items()}
    chk = {k: round(v["value"], 5) for k, v in res.get("checks", {}).items()}
    info = res.get("info", {})
    dev = res.get("device", {})
    return (f"{r['cell']} seed={r['seed']} trace={r['trace']} rc={r['rc']} wall={r['wall_s']:.1f} "
            f"correct={res.get('correct')} {json.dumps(m)} checks={json.dumps(chk)} "
            f"completed={info.get('completed')} peak_gb={dev.get('memory_peak_bytes', 0) / 1e9:.2f} "
            f"busy={dev.get('busy_s')} win={dev.get('window_s')} "
            f"tails={info.get('ttft_p95_ms')},{info.get('tpot_p95_ms')} "
            f"first_tokens={info.get('first_tokens')} warm_up={(info.get('setup_phases_s') or {}).get('warm_up')}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--stop", action="store_true")
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for spec in args.run:
        cell, seed, seconds, trace = spec.split(":")
        r = run_one(cell, int(seed), float(seconds), int(trace), args.timeout)
        with out.open("a") as f:
            f.write(json.dumps(r) + "\n")
        print(short(r), flush=True)
        if r["rc"] != 0:
            print(r["stderr_tail"][-1500:], flush=True)
        if args.stop and (r["rc"] != 0 or not (r["result"] or {}).get("correct")):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
