#!/usr/bin/env python3
"""Time this tree's CUDA kernels against another checkout's, on one card.

    git archive <commit> | tar -x -C build/parent    # a gitignored dir
    python3 kernel_ab.py build/parent [--arch granite-8b]

Each tree is timed through its own wrappers: the other tree's
``repro_torch.kernels`` is imported apart from this one's (its own
``_build``, sources and build directory), so the kernels' C interface
may differ between the trees; their Python entry points may not.  Both
trees are built first, then each kernel of a decoder-only arch's main
path (``chip_smoke.py``'s shapes, bf16 attention, fp32 RG-LRU scan, cold L2)
is timed in turns (other, this, this, other), three rounds, each reading
twice: CUDA events around the calls (``ms``, which includes a wrapper's
host path where that is the longer) and the kernel's own device time
under torch.profiler (``device ms``).  Prints the medians and every
reading, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

KERNELS = ("flash_attention", "decode_attention", "rglru_scan")


def load_tree(root: Path) -> dict:
    """``{kernel: wrapper}`` of the checkout at ``root``, imported apart
    from this tree's package (which is put back afterwards)."""
    def ours():
        return [k for k in sys.modules
                if k == "repro_torch" or k.startswith("repro_torch.")]
    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root / "src"))
    try:
        mods = {n: importlib.import_module(f"repro_torch.kernels.{n}")
                for n in KERNELS}
        mods["decode_attention"]._build.build_all()
    finally:
        sys.path.pop(0)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    return {n: getattr(m, n) for n, m in mods.items()}


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    # the decoder-only paths with attention: one causal prefill shape and
    # one self cache, the local layers' where the path has any (whisper's
    # encoder and cross shapes are timed by chip_smoke.py)
    ap.add_argument("--arch", default="granite-8b",
                    choices=[a for a in cs.PATHS
                             if not get_config(a).encoder_layers
                             and cs._per_call(get_config(a))[
                                 "flash_attention"]])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")

    _build.build_all()
    trees = {"other": load_tree(args.other.resolve()),
             "this": {n: importlib.import_module(
                 f"repro_torch.kernels.{n}").__dict__[n] for n in KERNELS}}
    print(f"[ab] built {args.other} and {REPO}", flush=True)

    spec = cs.PATHS[args.arch]
    B, S = spec["batch"], cs._prefill_len(args.arch)  # vision prefix too
    H, K, hd, window = cs._attn_shape(args.arch)
    cap = cs._softcap(args.arch)
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
    cache = spec["cache"] + get_config(args.arch).vision_tokens
    Sc = min(cache, window or cache)
    kv, qp = (cs._ring(Sc, Sc + 7, B) if window else
              cs._filled(S + 8, Sc, B))
    dsets = []
    for _ in range(cs.n_sets(2 * B * Sc * K * hd * 2)):
        q = cs._rand(gen, (B, 1, K, G, hd), dt)[:, 0]
        kc = cs._rand(gen, (B, Sc, K, hd), dt)
        vc = cs._rand(gen, (B, Sc, K, hd), dt)
        dsets.append((q, kc.transpose(1, 2), vc.transpose(1, 2)))
    # case: (wrapper of a tree -> timed fn, input sets, iters, kernel name)
    cases = {
        "flash_attention": (lambda fl: lambda q, k, v: fl(
            q, k, v, causal=True, window=window, softcap=cap), fsets, 50,
            "flash_fwd"),
        "decode_attention": (lambda de: lambda q, k, v: de(
            q, k, v, qp, kv, window=window, softcap=cap), dsets, 200,
            "decode_"),
    }
    shapes = (f"flash B={B} H={H} K={K} S={S} hd={hd} window={window} "
              f"softcap={cap}; decode B={B} K={K} G={G} S={Sc} hd={hd} "
              f"({'wrapped ring' if window else 'partly filled'}); bf16")
    R = get_config(args.arch).rglru_dim
    if R:
        rsets = [(torch.sigmoid(cs._rand(gen, (B, S, R), torch.float32)),
                  cs._rand(gen, (B, S, R), torch.float32))
                 for _ in range(cs.n_sets(3 * B * S * R * 4))]
        cases["rglru_scan"] = (lambda sc: sc, rsets, 50, "rglru_")
        shapes += f"; rglru_scan B={B} S={S} R={R} fp32"
    print(f"[ab] {args.arch}: {shapes}", flush=True)
    for name, (make, sets, iters, match) in cases.items():
        fns = {tree: make(w[name]) for tree, w in trees.items()}
        got = {tree: {"ms": [], "device ms": []} for tree in trees}
        for _ in range(3):
            for tree in ("other", "this", "this", "other"):
                got[tree]["ms"].append(cs.time_ms(fns[tree], sets,
                                                  iters=iters))
                got[tree]["device ms"].append(cs.device_ms(
                    fns[tree], sets, match, iters=iters))
        for tree, readings in got.items():
            for what, ms in readings.items():
                ms = sorted(x for x in ms if x is not None)
                med = f"{ms[len(ms) // 2]:.5f}" if ms else "not measured"
                print(f"[ab] {name} {tree} {what}: median {med}, all "
                      f"{[round(x, 5) for x in ms]}", flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
