"""Run one cell of the port's benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port.
The last line of standard output is the result (see ``harness.py``)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from harness import main

    sys.exit(main(sys.argv[1:], T_START))
