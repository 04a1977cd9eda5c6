"""Find an open-loop cell's knee once, on the card: the highest arrival
rate its one dispatcher sustains.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --fractions 0.7,0.8,0.9,1.0,1.1

Sets the cell up once, then serves the mix's trace back to back (a
closed loop) for ``seconds``: the completed invocations per second are
the capacity.  Then it replays the trace open-loop at each fraction of
that capacity and prints, per rate, the 90th percentile and median of
latency and how far the last fifth of the invocations waited past the
first fifth (a backlog that grows through the window shows there).
One JSON line per pass; the rate goes into the mix's ``rate_per_s`` by
hand, at about four fifths of the knee.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from portbench import bench  # noqa: E402
from portbench.metrics.latency_p90_s import p90  # noqa: E402


def pass_(cell, run, system, mix, seconds, closed):
    run = bench.Run(cell, run.cfg, mix, run.device)
    own = cell.generator
    if closed:
        cell.generator = bench.load_module(
            ROOT / "portbench" / "traffic" / "gen_closed.py")
    try:
        bench.drive(system, run, seconds, False)
    finally:
        cell.generator = own
    lat = [r["latency_s"] for r in run.records]
    n = len(lat)
    fifth = max(n // 5, 1)
    return {"invocations": n, "window_s": run.window_s,
            "per_s": n / run.window_s,
            "paths": {p: sum(r["path"] == p for r in run.records)
                      for p in {r["path"] for r in run.records}},
            "p90_s": p90(lat), "median_s": statistics.median(lat),
            "late_growth_s": (statistics.mean(lat[-fifth:])
                              - statistics.mean(lat[:fifth]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--fractions", default="0.7,0.8,0.9,1.0,1.1")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    bench.cache_dirs()
    args = bench.parse(["--workload", a.workload, "--seed", str(a.seed),
                        "--seconds", str(a.seconds), "--device", a.device])
    made = bench.setup(args, T_START)
    if made is None:
        return 2
    cell, run, system = made
    cap = pass_(cell, run, system, run.mix, a.seconds, closed=True)
    print(json.dumps({"closed_loop": cap}), flush=True)
    for f in (float(x) for x in a.fractions.split(",")):
        mix = dict(run.mix, rate_per_s=f * cap["per_s"])
        res = pass_(cell, run, system, mix, a.seconds, closed=False)
        print(json.dumps({"fraction": f, "rate_per_s": mix["rate_per_s"],
                          **res}), flush=True)
    system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
