"""Open loop: invocations arrive as a Poisson process at ``rate_per_s``
whether or not earlier ones have finished (independent users).  Each
has a due time; latency counts from it.

The arrival times and sizes are a fixed trace drawn from the mix's
``trace_seed``, replayed by every run: with one dispatcher at four
fifths of capacity, the 90th percentile of a ~50-invocation window
moves by a third or more from one Poisson draw to the next, far past
any bound a check could hold.  The run's seed draws what the trace
carries: the prompts' tokens and the functions' weights.
"""

from __future__ import annotations

from portbench.traffic import draw


def schedule(mix: dict, seconds: float) -> list[dict]:
    """The invocations due in [0, seconds), in arrival order."""
    out, t, i = [], 0.0, 0
    rate = mix["rate_per_s"]
    while True:
        inv = draw.invocation(mix, i)
        inv["due_s"] = t
        if t >= seconds:
            return out
        out.append(inv)
        t += float(draw.rng(mix["trace_seed"], "gap", i).exponential(
            1.0 / rate))
        i += 1
