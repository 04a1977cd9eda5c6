#!/usr/bin/env python3
"""One full-width model, cut in depth, through the JAX reference and the
PyTorch port on the CPU, on the same weights.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 fullwidth_parity.py \\
        [--arch granite-8b] [--layers 2] [--batch 2] [--prompt 16] [--new 8]

The reference's ``init_params`` draws the weights (fp32, published
widths, ``--layers`` layers); ``repro_torch.models.convert`` carries them
into the port.  Both prefill the same random prompt and decode greedily,
each from its own tokens; the script prints the prefill's and every
step's logits difference over the reference's scale, whether the two
packages pick the same tokens, and how many distinct tokens each emits
per row.  It fails if the logits differ by more than 2e-3 of their
scale (the reference's tolerance, tests/test_archs.py) or the tokens
differ.  A 2-layer granite-8b holds ~0.6 B fp32 parameters, ~2.5 GB per
copy: the script holds three copies (JAX, numpy, torch).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

TOL = 2e-3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro_torch.configs import get_config as t_config
    from repro_torch.models import model as TM
    from repro_torch.models.convert import from_numpy_tree

    torch.set_grad_enabled(False)
    kw = dict(n_layers=args.layers, dtype="float32")
    jcfg, tcfg = j_config(args.arch).with_(**kw), t_config(args.arch).with_(
        **kw)
    t0 = time.perf_counter()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(args.seed))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    n = TM.param_count(tcfg)
    print(f"{args.arch}: {args.layers} layers at full width (d_model "
          f"{tcfg.d_model}, vocab {tcfg.vocab}), {n} fp32 parameters; "
          f"weights drawn and converted in {time.perf_counter() - t0:.1f} s",
          flush=True)

    B, P, NEW = args.batch, args.prompt, args.new
    toks = np.random.default_rng(args.seed + 1).integers(
        0, tcfg.vocab, (B, P)).astype(np.int32)
    L = P + NEW
    jl, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks), cache_len=L)
    tl, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks),
                           cache_len=L)
    jt, tt, errs = [], [], []
    for i in range(NEW):
        ja, ta = np.asarray(jl, np.float32), tl.float().numpy()
        errs.append(float(np.abs(ta - ja).max() / np.abs(ja).max()))
        jt.append(ja.argmax(-1).astype(np.int32))
        tt.append(ta.argmax(-1).astype(np.int32))
        if i == NEW - 1:
            break
        pos = np.full((B,), P + i, np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jnp.asarray(jt[-1][:, None]),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams,
                                torch.from_numpy(tt[-1][:, None]),
                                torch.from_numpy(pos), tc)
    jt, tt = np.stack(jt, 1), np.stack(tt, 1)
    same = bool((jt == tt).all())
    print(f"logits max abs diff / max abs: prefill {errs[0]:.3e}, decode "
          f"steps {' '.join(f'{e:.3e}' for e in errs[1:])} (limit {TOL:g})")
    for b in range(B):
        print(f"row {b}: reference {jt[b].tolist()} ({len(set(jt[b]))} "
              f"distinct), port {tt[b].tolist()} ({len(set(tt[b]))} "
              "distinct)")
    print(f"greedy tokens identical: {same}; wall {time.perf_counter() - t0:.1f}"
          " s")
    if max(errs) > TOL or not same:
        sys.exit("fullwidth_parity: the port differs from the reference")


if __name__ == "__main__":
    main()
