"""Run one cell of BENCHMARK.json:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, and with ``--trace 1``
``breakdown``); the numbers compared beside their limits are the last
lines of standard error. Exits non-zero, with no result, without enough
CUDA devices."""

import os.path as osp
import sys
import time

T_PROCESS = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
