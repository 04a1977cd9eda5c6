#!/usr/bin/env python3
"""Time this tree's CUDA kernels against another checkout's, on one card.

    git archive <commit> | tar -x -C build/parent    # a gitignored dir
    python3 kernel_ab.py build/parent [--arch granite-8b]

Builds both trees' ``src/repro_torch/kernels/csrc`` with nvcc, then
times each kernel of the arch's main path (``chip_smoke.py``'s shapes,
bf16, cold L2) with this tree's wrappers over each tree's library, in
turns (other, this, this, other) and three rounds, and prints the
median and every reading.  The wrappers' C interface must be the same in
both trees; a kernel the other tree lacks, or a shape it rejects, fails
the run.  Ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--arch", default="granite-8b", choices=list(cs.PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")

    libs = {}
    for tree, root in (("other", args.other.resolve()), ("this", REPO)):
        _build.CSRC = root / "src" / "repro_torch" / "kernels" / "csrc"
        _build._libs = {}
        _build.build_all()
        for name in _build.sources():
            _build.load(name)
        libs[tree] = _build._libs
        print(f"[ab] {tree}: built {sorted(libs[tree])} from {_build.CSRC}",
              flush=True)

    spec = cs.PATHS[args.arch]
    B, S = spec["batch"], spec["prefill"]
    H, K, hd, window = cs._attn_shape(args.arch)
    G = H // K
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = 2 * (B * S * H * hd + 2 * B * S * K * hd)
    fsets = []
    for _ in range(cs.n_sets(one)):
        q5 = cs._rand(gen, (B, S, K, G, hd), dt)
        k4 = cs._rand(gen, (B, S, K, hd), dt)
        v4 = cs._rand(gen, (B, S, K, hd), dt)
        fsets.append((q5.reshape(B, S, H, hd).transpose(1, 2),
                      k4.transpose(1, 2), v4.transpose(1, 2)))
    Sc = min(spec["cache"], window or spec["cache"])
    kv, qp = (cs._ring(Sc, Sc + 7, B) if window else
              cs._filled(S + 8, Sc, B))
    dsets = []
    for _ in range(cs.n_sets(2 * B * Sc * K * hd * 2)):
        q = cs._rand(gen, (B, 1, K, G, hd), dt)[:, 0]
        kc = cs._rand(gen, (B, Sc, K, hd), dt)
        vc = cs._rand(gen, (B, Sc, K, hd), dt)
        dsets.append((q, kc.transpose(1, 2), vc.transpose(1, 2)))
    cases = {
        "flash_attention": (lambda q, k, v: flash_attention(
            q, k, v, causal=True, window=window), fsets, 50),
        "decode_attention": (lambda q, k, v: decode_attention(
            q, k, v, qp, kv, window=window), dsets, 200),
    }
    print(f"[ab] {args.arch}: flash B={B} H={H} K={K} S={S} hd={hd} "
          f"window={window}; decode B={B} K={K} G={G} S={Sc} hd={hd} "
          f"({'wrapped ring' if window else 'partly filled'}); bf16",
          flush=True)
    for name, (fn, sets, iters) in cases.items():
        got = {"other": [], "this": []}
        for _ in range(3):
            for tree in ("other", "this", "this", "other"):
                _build._libs = libs[tree]
                got[tree].append(cs.time_ms(fn, sets, iters=iters))
        for tree, ms in got.items():
            ms = sorted(ms)
            print(f"[ab] {name} {tree}: median {ms[len(ms) // 2]:.5f} ms, "
                  f"all {[round(x, 5) for x in ms]}", flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
