"""Report loading for ``EnginePool.rewarm`` (the port's copy of what
``repro.api.artifacts.as_report`` gives it).

``as_report`` takes a report object (duck-typed: the port cannot import
``repro.core``'s ``OptimizationReport``, so anything with its
``application`` and ``defer_targets`` passes as it is) or
the path of a saved ``optimization_report`` artifact: the JSON envelope
``{"kind": "optimization_report", "schema_version": N, ...}`` that
``repro.api.artifact`` writes (version 1 files may lack the envelope).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

KIND = "optimization_report"
SCHEMA_VERSION = 2
REQUIRED_KEYS = ("application", "e2e_s", "total_init_s", "qualifies",
                 "stats", "findings", "defer_targets")
OPTIONAL_KEYS = ("meta",)


class ArtifactError(ValueError):
    """A file failed to load as a report artifact; names the path."""

    def __init__(self, path: str, detail: str) -> None:
        self.path = path
        super().__init__(f"{path}: {detail}")


@dataclasses.dataclass(frozen=True)
class Report:
    """A loaded report artifact's payload (stats and findings as the
    artifact's dicts)."""
    application: str
    e2e_s: float
    total_init_s: float
    qualifies: bool
    stats: list
    findings: list
    defer_targets: list
    meta: dict = dataclasses.field(default_factory=dict)


def load_report(path: str) -> Report:
    """Load and validate a saved report artifact (versions 1 and 2)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError as exc:
        raise ArtifactError(path, f"cannot read: {exc}") from exc
    except ValueError as exc:
        raise ArtifactError(path, f"invalid/truncated JSON: {exc}") from exc
    if not isinstance(doc, dict):
        raise ArtifactError(path, f"expected a JSON object, got "
                                  f"{type(doc).__name__}")
    kind = doc.pop("kind", None)
    if kind is not None and kind != KIND:
        raise ArtifactError(path, f"kind mismatch: file is {kind!r}, "
                                  f"expected {KIND!r}")
    version = doc.pop("schema_version", 1)
    if not isinstance(version, int) or not 1 <= version <= SCHEMA_VERSION:
        raise ArtifactError(path, f"schema_version {version!r} not in "
                                  f"1..{SCHEMA_VERSION}")
    missing = set(REQUIRED_KEYS) - set(doc)
    unknown = set(doc) - set(REQUIRED_KEYS) - set(OPTIONAL_KEYS)
    if missing or unknown:
        raise ArtifactError(path, f"{KIND} schema violation: missing "
                                  f"{sorted(missing)}, unknown "
                                  f"{sorted(unknown)}")
    return Report(**{k: doc[k] for k in REQUIRED_KEYS},
                  meta=doc.get("meta") or {})


def as_report(obj: Any):
    """A report object as it is, or the report saved at a path; raises
    TypeError for anything else."""
    if hasattr(obj, "application") and hasattr(obj, "defer_targets"):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        return load_report(os.fspath(obj))
    raise TypeError(f"expected a report object or the path of a saved "
                    f"report artifact, got {type(obj).__name__}")
