"""Readings for a cell's limits, on the card at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 15 [--control]

For each seed, in one process: the cell's set-up, a window of
``seconds`` at the cell's own load, then the check's sample against the
float32 reference, printing the program's ``gen_gap``, ``score_gap``
and ``logit_err`` and, with ``--control``, the same numbers of the
control (the reference
with every matmul in float8 e4m3, the next precision below the served
bf16) on the same prompts and tokens.  The benchmark's own runs never
run the control.  One JSON line per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from portbench import bench, check  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    bench.cache_dirs()
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        args = bench.parse(["--workload", a.workload, "--seed", str(seed),
                            "--seconds", str(a.seconds), "--device",
                            a.device])
        made = bench.setup(args, t0)
        if made is None:
            return 2
        cell, run, system = made
        bench.drive(system, run, a.seconds, False)
        system.close()
        del system
        picked = check.sample(run.records, run.outputs, run.mix, seed)
        t1 = time.perf_counter()
        gaps = check.reference_gaps(run.cfg, picked, run.outputs, seed,
                                    a.device, last_logits=run.last_logits,
                                    control=a.control)
        print(json.dumps({
            "seed": seed, "invocations": len(run.records),
            "failed": sum(not r["ok"] for r in run.records),
            "checked": [(r["entry"], r["path"], r["prompt_len"])
                        for r in picked],
            "reference_s": time.perf_counter() - t1, **gaps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
