"""Fault tolerance: straggler watchdog and checkpoint/restart loop (the
port's own copy of ``repro.training.fault``, which imports no JAX).

The driver wraps every training step with a wall-clock deadline.  A
step exceeding ``soft_deadline`` is recorded as a straggler event (on a
real multi-host fleet this feeds the controller that re-slices the job
around slow hosts); exceeding ``hard_deadline`` or raising triggers the
restart path: reload the latest checkpoint and continue
(``repro_torch.training.checkpoint``; one device: no re-sharding yet).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerStats:
    steps: int = 0
    slow_steps: int = 0
    restarts: int = 0
    worst_step_s: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


class StepWatchdog:
    """Deadline accounting around synchronous steps."""

    def __init__(self, soft_deadline_s: float, hard_deadline_s:
                 Optional[float] = None):
        self.soft = soft_deadline_s
        self.hard = hard_deadline_s or (soft_deadline_s * 10)
        self.stats = StragglerStats()

    def run(self, fn: Callable, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        self.stats.steps += 1
        self.stats.worst_step_s = max(self.stats.worst_step_s, dt)
        if dt > self.soft:
            self.stats.slow_steps += 1
        if dt > self.hard:
            raise StragglerTimeout(
                f"step took {dt:.2f}s > hard deadline {self.hard:.2f}s")
        return out


class StragglerTimeout(RuntimeError):
    pass


class RestartableLoop:
    """Run a step loop with automatic restart-from-checkpoint.

    ``make_state()`` builds fresh state; ``save(step, state)`` /
    ``restore(step)`` persist it; ``step_fn(step, state)`` advances.
    Injected failures (tests) and StragglerTimeout both route through
    the restart path, bounded by ``max_restarts``.
    """

    def __init__(self, *, step_fn, make_state, save, restore,
                 latest, ckpt_every: int = 10, max_restarts: int = 3,
                 watchdog: Optional[StepWatchdog] = None):
        self.step_fn = step_fn
        self.make_state = make_state
        self.save = save
        self.restore = restore
        self.latest = latest
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StepWatchdog(soft_deadline_s=60.0)

    def run(self, n_steps: int):
        restarts = 0
        last = self.latest()
        if last is not None:
            step, state = self.restore(last)
        else:
            step, state = 0, self.make_state()
        while step < n_steps:
            try:
                state = self.watchdog.run(self.step_fn, step, state)
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    self.save(step, state)
            except Exception:
                restarts += 1
                self.watchdog.stats.restarts = restarts
                if restarts > self.max_restarts:
                    raise
                last = self.latest()
                if last is None:
                    step, state = 0, self.make_state()
                else:
                    step, state = self.restore(last)
        return step, state, self.watchdog.stats
