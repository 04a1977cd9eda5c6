"""Labelled counters with plain-JSON snapshots (the port's copy of what
``EnginePool`` uses from ``repro.obs.metrics``).

``registry.counter(name, ...)`` is idempotent: it returns the existing
family when called again with the same label set, so instrumented code
looks families up at call sites.  :meth:`MetricsRegistry.snapshot` has
the reference's shape (``{"schema", "families": [{"name", "kind",
"help", "labels", "series": [{"labels", "value"}]}]}``).
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Counter:
    """A counter family: one child series per label-value tuple."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str]) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name: {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name: {ln!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _CounterChild] = {}

    def labels(self, **labels: str) -> _CounterChild:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[ln]) for ln in self.label_names)
        with self._lock:
            return self._children.setdefault(key, _CounterChild())

    def inc(self, amount: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} has labels {self.label_names}; "
                             "use .labels(...)")
        self.labels().inc(amount)

    def series(self) -> List[Tuple[Tuple[str, ...], _CounterChild]]:
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """A named collection of counter families."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, Counter] = {}

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = Counter(name, help, labels)
            elif fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered with labels "
                    f"{tuple(labels)} (was {fam.label_names})")
            return fam

    def families(self) -> List[Counter]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    def snapshot(self) -> dict:
        """Plain-JSON dump of every series."""
        return {"schema": "repro.metrics/1", "families": [
            {"name": fam.name, "kind": fam.kind, "help": fam.help,
             "labels": list(fam.label_names),
             "series": [{"labels": list(key), "value": child.value}
                        for key, child in fam.series()]}
            for fam in self.families()]}


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry used by the built-in instrumentation."""
    return _DEFAULT
