"""End-to-end training driver: a granite-family model for a few hundred
steps on the synthetic pipeline, with checkpointing and straggler
accounting (twin of the reference's ``examples/train_100m.py``).
CPU-sized by default; ``--full-width`` takes the ~100M config.

    PYTHONPATH=src python -m repro_torch.examples.train_100m \\
        [--steps 200] [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_config("granite-8b")
    if args.full_width:
        # ~100M: 12L x 768 with the granite block structure
        cfg = base.with_(n_layers=12, d_model=768, n_heads=12,
                         n_kv_heads=4, head_dim=64, d_ff=2048,
                         vocab=32768, dtype="float32", loss_chunk=0)
    else:
        # CPU-friendly stand-in with the same code paths
        cfg = base.with_(n_layers=4, d_model=256, n_heads=8,
                         n_kv_heads=4, head_dim=32, d_ff=688,
                         vocab=8192, dtype="float32", loss_chunk=0)

    _, _, summary = train(cfg, steps=args.steps, batch=args.batch,
                          seq=args.seq, lr=1e-3, ckpt_dir=args.ckpt_dir,
                          ckpt_every=50, log_every=20, device=args.device)
    losses = summary["losses"]
    print(f"\nloss: first10 {np.mean(losses[:10]):.3f} -> "
          f"last10 {np.mean(losses[-10:]):.3f}")
    print(f"straggler stats: {summary['straggler']}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), \
        "training must reduce loss"
    print("OK")
    return summary


if __name__ == "__main__":
    main()
