"""Serving example: continuous batching (twin of the reference's
``examples/serve_continuous.py``).

Builds a reduced MoE model and drives the slot-based continuous batcher
with ten requests of random lengths.  On the card the decode step is a
CUDA graph over the batcher's caches (``DecodeGraph``); with
``--device cpu`` it runs eagerly.

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.models.model import decode_step, init_cache, init_params, \
    prefill
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.serving.graphs import DecodeGraph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cfg = get_reduced("granite-moe-1b-a400m")
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device)
    n_slots, cache_len = 4, 64

    def prefill_fn(tokens):
        logits, caches, _ = prefill(cfg, params, tokens,
                                    cache_len=cache_len)
        return logits.argmax(-1).to(torch.int32), caches

    caches = init_cache(cfg, n_slots, cache_len, device)
    if device.type == "cuda":
        graph = DecodeGraph(lambda p, tok, pos, c: decode_step(cfg, p, tok,
                                                               pos, c),
                            params, caches, n_slots, device)

        def decode_fn(tok, pos, caches):
            return graph(tok, pos)[0], caches
    else:
        def decode_fn(tok, pos, caches):
            logits, caches = decode_step(cfg, params, tok, pos, caches)
            return logits.argmax(-1).to(torch.int32)[:, None], caches

    batcher = ContinuousBatcher(prefill_fn, decode_fn, caches,
                                n_slots=n_slots)
    rng = np.random.default_rng(0)
    for rid in range(10):
        L = int(rng.integers(4, 12))
        batcher.submit(Request(
            rid=rid, tokens=rng.integers(0, cfg.vocab, (L,)),
            max_new_tokens=int(rng.integers(3, 8))))
    stats = batcher.run_until_drained()
    print("batcher stats:", stats)
    for r in sorted(batcher.finished, key=lambda r: r.rid)[:5]:
        print(f"  req {r.rid}: +{len(r.out_tokens)} tokens "
              f"{r.out_tokens[:6]}")
    if stats["finished"] != 10:
        raise RuntimeError(f"{stats['finished']} of 10 requests finished")
    print("OK")
    return stats


if __name__ == "__main__":
    main()
