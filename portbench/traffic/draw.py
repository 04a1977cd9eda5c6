"""Draws shared by the traffic generators: one invocation's sizes.

Every quantity has its own random stream, keyed by (the mix's
``trace_seed``, the quantity, the invocation's index), so a schedule's
first n invocations are the same whatever its length, and changing one
parameter changes only its own quantity.
"""

from __future__ import annotations

import numpy as np

_STREAMS = {"gap": 1, "function": 2, "entry": 3, "prompt": 4}


def rng(trace_seed: int, what: str, i: int) -> np.random.Generator:
    return np.random.default_rng([trace_seed, _STREAMS[what], i])


def zipf_probs(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def prompt_len(p: dict, u: float) -> int:
    """Log-normal length at standard normal draw ``u`` (the median itself
    where ``sigma`` is 0 or absent), clipped to [min, max] where the mix
    gives them, and rounded up to a multiple of ``round_to`` (so a run
    uses few distinct shapes, each warmed up before the window)."""
    raw = p["median"] * np.exp(p.get("sigma", 0.0) * u)
    raw = min(max(raw, p.get("min", 1)), p.get("max", raw))
    r = p["round_to"]
    n = -(-int(np.ceil(raw)) // r) * r
    return int(min(n, p["max"])) if "max" in p else int(n)


def prompt_lengths(p: dict) -> list[int]:
    """Every length ``prompt_len`` can give."""
    if not p.get("sigma", 0.0):
        return [prompt_len(p, 0.0)]
    r = p["round_to"]
    lo = -(-p["min"] // r) * r
    return sorted({min(n, p["max"]) for n in range(lo, p["max"] + r, r)})


def invocation(mix: dict, i: int) -> dict:
    """Invocation i's function rank (0 most popular), entry, prompt
    length and new tokens."""
    ts = mix["trace_seed"]
    n_fn = mix.get("functions", 1)
    fn = 0
    if n_fn > 1:
        fn = int(rng(ts, "function", i).choice(
            n_fn, p=zipf_probs(n_fn, mix["zipf_s"])))
    names = sorted(mix["entries"])
    probs = np.array([mix["entries"][e] for e in names], dtype=float)
    entry = names[int(rng(ts, "entry", i).choice(len(names),
                                                 p=probs / probs.sum()))]
    u = float(rng(ts, "prompt", i).standard_normal())
    return {"i": i, "function": fn, "entry": entry,
            "prompt_len": prompt_len(mix["prompt"], u),
            "new_tokens": mix["new_tokens"] if entry != "score" else 0}
