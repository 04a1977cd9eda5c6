"""Quickstart, Level B: the SLIMSTART loop on model-serving cold starts
(twin of ``level_b`` in the reference's ``examples/quickstart.py``).

An eager engine serves one request; its utilization report becomes a
load policy; a second engine cold-starts under it and serves the same
request.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.serving import LoadPolicy, ServingEngine


def level_b(device: str = "cuda"):
    print("=" * 64)
    print(f"Level B: model-serving cold starts (PyTorch port, {device})")
    print("=" * 64)
    cfg = get_reduced("granite-moe-1b-a400m")
    eager = ServingEngine(cfg, prefill_len=8, device=device)
    cold_eager = eager.cold_start()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 8))
    eager.serve("generate", toks, max_new_tokens=4)
    policy = LoadPolicy.from_report(eager.report())

    slim = ServingEngine(cfg, policy=policy, prefill_len=8, device=device)
    cold_slim = slim.cold_start()
    out, lat = slim.serve("generate", toks, max_new_tokens=4)
    print(f"eager cold start     : {cold_eager:.3f} s")
    print(f"slimstart cold start : {cold_slim:.3f} s "
          f"({cold_eager / max(cold_slim, 1e-9):.2f}x)")
    print(f"first request        : {lat:.3f} s -> tokens {out[0].tolist()}")
    print(f"deferred components  : {sorted(policy.lazy_names)[:6]} ...")
    return out, policy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    level_b(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
