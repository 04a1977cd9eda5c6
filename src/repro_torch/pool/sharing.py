"""The shared hot set of a pool's members (the port's copy of
``repro.pool.sharing.intersect_hot_sets``)."""

from __future__ import annotations

from typing import Mapping, Sequence


def _covers(module: str, hot_set: Sequence[str]) -> bool:
    """True when importing ``hot_set`` already loads ``module`` (the
    module itself or a package prefix of it is in the set)."""
    parts = module.split(".")
    prefixes = {".".join(parts[:i]) for i in range(1, len(parts) + 1)}
    return any(m in prefixes for m in hot_set)


def intersect_hot_sets(hot_sets: Mapping[str, Sequence[str]], *,
                       min_members: int = 2,
                       prefixes: bool = True) -> list[str]:
    """Names hot for at least ``min_members`` of the given members.

    With ``prefixes=True`` (module semantics): ``pkg`` in one member's
    set covers ``pkg.sub`` in another's, and the *widest* common prefix
    wins.  Pass ``prefixes=False`` for flat namespaces where a dot is
    not a containment relation -- ``EnginePool``'s component names,
    where ``expert.1`` and ``expert.2`` share no loadable parent.
    """
    if not hot_sets:
        return []
    min_members = max(1, min_members)
    counts: dict[str, int] = {}
    exact: set[str] = set()
    for hot in hot_sets.values():
        seen = set()
        for mod in hot:
            mod = mod.strip()
            if not mod:
                continue
            exact.add(mod)
            if prefixes:
                # credit the name and every package prefix, once per
                # member
                parts = mod.split(".")
                for i in range(1, len(parts) + 1):
                    seen.add(".".join(parts[:i]))
            else:
                seen.add(mod)
        for name in seen:
            counts[name] = counts.get(name, 0) + 1
    if not prefixes:
        return sorted(m for m, n in counts.items() if n >= min_members)

    def qualifies(name: str) -> bool:
        if counts[name] < min_members:
            return False
        if name in exact:
            return True
        # a synthetic prefix (no member names it as-is) earns a slot
        # only when it aggregates demand: more members than any one of
        # its submodules alone
        best_child = max((counts[m] for m in exact
                          if m != name and _covers(m, [name])),
                         default=0)
        return counts[name] > best_child

    shared = [m for m in counts if qualifies(m)]
    # keep maximal prefixes only (importing pkg imports pkg.sub)
    shared.sort(key=lambda p: (p.count("."), p))
    keep: list[str] = []
    for mod in shared:
        if not _covers(mod, keep):
            keep.append(mod)
    return keep
