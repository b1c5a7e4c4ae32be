"""The port's benchmark, one cell a run:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
BENCHMARK.json at the checkout's root (h100bench/harness/spec.py).  The
run needs the card: without CUDA, or with fewer devices than the cell
asks for, it exits non-zero and prints no result.
"""

import os
import sys
import time

if __name__ == "__main__":
    _t0 = time.perf_counter()
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = _root
    from h100bench.harness import cell

    sys.exit(cell.main(t_start=_t0 - cell.process_age_s()))
