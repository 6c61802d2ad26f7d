"""Run one cell of the benchmark that BENCHMARK.json defines.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the cell's result as one JSON line, the
last line of its standard output; the numbers its answers were judged by,
each beside its limit, are the last lines of its standard error.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START))
