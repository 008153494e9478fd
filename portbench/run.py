"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``tpu_renderer_torch``. It exits
with a code other than 0, and prints no result, without enough CUDA
devices. See portbench/harness.py.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
