"""Cold-start components — the Level-B analogue of Python libraries
(PyTorch port of ``repro.serving.components``).

A serverless model server's cold start decomposes into named components:
weight groups (embeddings, layer stacks, lm head), modality frontends
(vision projection, audio encoder), per-expert weight slices, and one
compiled executable per entry point.  Each component knows how to
materialize itself and records its init cost — feeding the same
hierarchical breakdown (paper Eq. 1-3) and utilization metric (Eq. 4)
as the Level-A profiler, with the *actuator* swapped from "deferred
import" to deferred materialization / compilation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class Component:
    """One lazily-materializable unit of server state."""
    name: str
    group: str  # "weights" | "frontend" | "experts" | "compile"
    build: Callable[[], Any]
    eager: bool = True  # load at cold start (vs on first use)
    value: Any = None
    ready: bool = False
    init_time: float = 0.0
    uses: int = 0

    def get(self):
        if not self.ready:
            t0 = time.perf_counter()
            self.value = self.build()
            if torch.cuda.is_initialized():
                # the init time includes the device work the build queued
                torch.cuda.synchronize()
            self.init_time += time.perf_counter() - t0
            self.ready = True
        self.uses += 1
        return self.value

    def drop(self):
        self.value = None
        self.ready = False


@dataclasses.dataclass(frozen=True)
class LoadPolicy:
    """Which components to materialize at cold start.

    eager_all        — the unoptimized baseline (everything up front).
    lazy set         — names/groups deferred to first use.
    prewarm set      — names compiled/materialized at startup even if
                       their group is lazy (profile-guided hot set).
    """
    lazy_groups: frozenset[str] = frozenset()
    lazy_names: frozenset[str] = frozenset()
    prewarm: frozenset[str] = frozenset()

    @staticmethod
    def eager_all() -> "LoadPolicy":
        return LoadPolicy()

    @staticmethod
    def from_report(report: dict, *, util_threshold=0.02) -> "LoadPolicy":
        """Build a policy from a SLIMSTART engine report: defer every
        component whose utilization is below threshold (paper's 2%)."""
        lazy = frozenset(
            row["component"] for row in report["components"]
            if row["utilization"] < util_threshold and row["init_s"] > 0)
        hot = frozenset(
            row["component"] for row in report["components"]
            if row["utilization"] >= util_threshold)
        return LoadPolicy(lazy_names=lazy, prewarm=hot)

    def is_lazy(self, comp: Component) -> bool:
        if comp.name in self.prewarm:
            return False
        return comp.group in self.lazy_groups or \
            comp.name in self.lazy_names


class ComponentRegistry:
    """Named components + init-time hierarchy (Eq. 1-3 at Level B)."""

    def __init__(self):
        self._comps: dict[str, Component] = {}

    def add(self, comp: Component):
        self._comps[comp.name] = comp
        return comp

    def __getitem__(self, name: str) -> Component:
        return self._comps[name]

    def __contains__(self, name):
        return name in self._comps

    def values(self):
        return self._comps.values()

    def materialize_eager(self, policy: LoadPolicy):
        for comp in self._comps.values():
            if not policy.is_lazy(comp):
                comp.get()
                comp.uses -= 1  # startup materialization isn't a use

    # ---------------------------------------------------- init hierarchy
    def total_init_time(self) -> float:
        return sum(c.init_time for c in self._comps.values())

    def group_init_times(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for c in self._comps.values():
            out[c.group] = out.get(c.group, 0.0) + c.init_time
        return out

    def utilization(self) -> dict[str, float]:
        """Eq. 4 with component uses as the sample counts."""
        total = sum(c.uses for c in self._comps.values()) or 1
        return {c.name: c.uses / total for c in self._comps.values()}

    def report(self) -> dict:
        util = self.utilization()
        rows = [{
            "component": c.name,
            "group": c.group,
            "init_s": round(c.init_time, 4),
            "uses": c.uses,
            "utilization": round(util[c.name], 4),
            "ready": c.ready,
        } for c in self._comps.values()]
        rows.sort(key=lambda r: -r["init_s"])
        return {
            "total_init_s": round(self.total_init_time(), 4),
            "by_group": {k: round(v, 4)
                         for k, v in self.group_init_times().items()},
            "components": rows,
        }
