"""Serving launcher: SLIMSTART-instrumented serverless model server
(PyTorch port of ``repro.launch.serve``).

Runs the paper's full CI/CD loop on a real model:
  1. cold start under a policy (eager | lazy | slimstart),
  2. serve a skewed multi-entry workload (the paper's Fig. 3 shape),
  3. emit the SLIMSTART report; ``slimstart`` first profiles an eager
     service on the same workload and re-derives the policy from its
     report (the Level-B analogue of the AST deferred-import rewrite).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --requests 20 --policy slimstart

``main`` serves the arch's reduced config, as the reference does, on
the card unless ``--device cpu`` is given; ``run_service`` takes the
shapes and the config, so a caller can drive a full-width model.  On
the card every decode step of a generating entry replays the entry's
CUDA graph, captured in its ``compile.<entry>`` warm-up
(``ServingEngine``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.serving import LoadPolicy, ServingEngine


def skewed_workload(entries, n, seed=0, alpha=0.85):
    """Zipf-skewed entry mix: the top handler dominates (Obs. 3)."""
    rng = np.random.default_rng(seed)
    p = np.array([alpha ** i for i in range(len(entries))], np.float64)
    p /= p.sum()
    # make the skew strong: square and renormalize
    p = p ** 3
    p /= p.sum()
    return [entries[i] for i in rng.choice(len(entries), size=n, p=p)]


def run_service(cfg, policy, requests, *, seed=0, max_new=4, batch_size=1,
                prompt_len=8, max_len=32, device="cuda"):
    """Cold-start an engine under ``policy`` and serve ``requests`` (entry
    names) with random prompts from ``seed``.  Returns (engine,
    cold_start_s, {entry: [latency_s, ...]})."""
    eng = ServingEngine(cfg, policy=policy, batch_size=batch_size,
                        prefill_len=prompt_len, max_len=max_len,
                        device=device)
    cold = eng.cold_start()
    rng = np.random.default_rng(seed)
    lat = {}
    for entry in requests:
        toks = rng.integers(0, cfg.vocab, (batch_size, prompt_len))
        _, dt = eng.serve(entry, toks, max_new_tokens=max_new)
        lat.setdefault(entry, []).append(dt)
    return eng, cold, lat


def lazy_policy() -> LoadPolicy:
    """Defer every deferrable group (the bench's lazy-all policy)."""
    return LoadPolicy(lazy_groups=frozenset(
        {"compile", "frontend", "experts"}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--policy", default="slimstart",
                    choices=["eager", "lazy", "slimstart"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    probe = ServingEngine(cfg, batch_size=1, device=args.device)
    entries = probe.entries()
    workload = skewed_workload(entries, args.requests, seed=args.seed)

    if args.policy == "eager":
        policy = LoadPolicy.eager_all()
    elif args.policy == "lazy":
        policy = lazy_policy()
    else:
        # profile-guided: run an eager profiling pass first, then build
        # the policy from the report (the paper's CI/CD loop)
        prof_eng, _, _ = run_service(cfg, LoadPolicy.eager_all(),
                                     workload, seed=args.seed,
                                     device=args.device)
        policy = LoadPolicy.from_report(prof_eng.report())
        del prof_eng

    eng, cold, lat = run_service(cfg, policy, workload, seed=args.seed,
                                 device=args.device)
    rep = eng.report()
    out = {
        "arch": cfg.name,
        "policy": args.policy,
        "cold_start_s": round(cold, 4),
        "entry_latency_mean_s": {
            k: round(float(np.mean(v)), 4) for k, v in lat.items()},
        "total_init_s": rep["total_init_s"],
        "by_group": rep["by_group"],
        "entry_counts": rep["entry_counts"],
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
