"""Closed loop: one client sends its next invocation as soon as the
last one returns (an offline batch job driven through the functions).
Invocations have no due time; the window runs whole invocations until
``seconds`` have passed, and the last one ends it.  Sizes come from
the mix's ``trace_seed``, as in the open loop.
"""

from __future__ import annotations

import itertools

from portbench.traffic import draw


def schedule(mix: dict, seconds: float):
    """An endless iterator of invocations (``due_s`` None)."""
    for i in itertools.count():
        inv = draw.invocation(mix, i)
        inv["due_s"] = None
        yield inv
