"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
JSON result; the numbers compared for ``correct`` end standard error.
"""

import time

T_START = time.perf_counter()  # set-up counts from here, before imports

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the script's own folder leaves the path: its modules are portbench.*
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from portbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(t_start=T_START))
