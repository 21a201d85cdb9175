"""Entry point of the benchmark: run one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (`tngp_torch`), on a
machine with the CUDA card(s) the cell asks for; see benchmark/harness.py.
"""

import time

T_START = time.time()  # set-up is timed from here, before any import

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
