"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``) and
``BENCHMARK.json``. See ``harness/cli.py``.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
# the CUDA driver's JIT cache, at a fixed place inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, "build", "portbench", "cuda-cache"))

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
