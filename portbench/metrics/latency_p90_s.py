"""latency_p90_s: the 90th percentile (nearest rank) of response time
over every invocation due in the window, counted from its due time to
the return of ``EnginePool.dispatch``.  One that failed, or never
returned, counts with the time until the harness gave up on it, so it
sits in the tail.  Open-loop cells only: a closed loop has no due
time."""

import math

SOURCE = "host_clock"


def p90(values):
    v = sorted(values)
    return v[math.ceil(0.9 * len(v)) - 1] if v else None


def read(run):
    if run.closed:
        return None
    return p90([r["latency_s"] for r in run.records])
