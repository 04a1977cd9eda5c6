"""Training driver (PyTorch port of ``repro.launch.train``): data
pipeline -> train step -> checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --reduced --steps 20 --device cpu

Runs on the card unless ``--device cpu`` is given (the kernels'
forwards, the plain attention backward).  With ``--ckpt-dir`` it
resumes from the latest checkpoint there (written by this package or by
the reference) and saves every ``ckpt_every`` steps and at the end.
Prints one JSON line with the reference's keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models.model import init_params
from repro_torch.training.adamw import adamw_init
from repro_torch.training.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.training.data import make_pipeline
from repro_torch.training.fault import StepWatchdog
from repro_torch.training.step import make_train_step


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          accum: int = 1, ckpt_dir=None, ckpt_every: int = 50,
          seed: int = 0, log_every: int = 10, compress_fn=None,
          soft_deadline_s: float = 300.0, device: str = "cuda"):
    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    opt = adamw_init(params)
    step0 = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            (params, opt), meta = restore_checkpoint(ckpt_dir, last,
                                                     (params, opt))
            step0 = meta["step"]
            print(f"[train] resumed from step {step0}")

    step_fn = make_train_step(cfg, lr=lr, accum_steps=accum,
                              compress_fn=compress_fn)
    data = make_pipeline(cfg.vocab, batch, seq, seed=seed)
    watchdog = StepWatchdog(soft_deadline_s=soft_deadline_s)

    def step_and_loss(params, opt, batch_t):
        params, opt, metrics = step_fn(params, opt, batch_t)
        return params, opt, float(metrics["loss"])  # the step's one sync

    losses = []
    t_start = time.time()
    for step in range(step0, steps):
        batch_t = {k: torch.as_tensor(v, device=device)
                   for k, v in next(data).items()}
        params, opt, loss = watchdog.run(step_and_loss, params, opt, batch_t)
        losses.append(loss)
        if (step + 1) % log_every == 0:
            dt = time.time() - t_start
            tps = (step + 1 - step0) * batch * seq / max(dt, 1e-9)
            print(f"[train] step {step+1}/{steps} loss={loss:.4f} "
                  f"tok/s={tps:,.0f}")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, (params, opt))
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, (params, opt))
    return params, opt, {"losses": losses,
                         "straggler": watchdog.stats.as_dict()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    _, _, summary = train(cfg, steps=args.steps, batch=args.batch,
                          seq=args.seq, lr=args.lr, accum=args.accum,
                          ckpt_dir=args.ckpt_dir, seed=args.seed,
                          device=args.device)
    first = np.mean(summary["losses"][:10])
    lastl = np.mean(summary["losses"][-10:])
    print(json.dumps({"first10_loss": round(float(first), 4),
                      "last10_loss": round(float(lastl), 4),
                      "straggler": summary["straggler"]}))
    return summary


if __name__ == "__main__":
    main()
