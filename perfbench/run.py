"""The benchmark's one command, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It runs on the machine it is started on and needs as many CUDA devices as
the cell asks for (else it exits 2 and prints no result). The last line
of standard output is the result's JSON object."""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder, whose module names
# must not shadow others
sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
