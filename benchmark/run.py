"""Run one cell of BENCHMARK.json on the card and print one JSON line:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits with another code than 0, printing no
result, without a CUDA device or with fewer than the cell asks for.
``--patch <name>`` runs one of the cell's controls or planted faults (the
``PATCHES`` of its system), which has to print ``"correct": false``."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[0] = str(CHECKOUT)   # the checkout, not this folder: its modules are not top-level

from benchmark import harness  # noqa: E402

os.environ.update(harness.cache_env())

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
