"""Run one cell of the benchmark once on the card.

    python3 vosbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (see vosbench/README.md).
Exits non-zero, printing no result, without enough CUDA devices, outside a
checkout that holds the program, or when a forbidden module is loaded.
"""
import time

T0 = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, in place of this directory: the benchmark's modules
# are imported as the vosbench package only
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from vosbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
