"""Checkpoint save / restore (PyTorch port of
``repro.training.checkpoint``), on the reference's on-disk layout:

  step_XXXXXXXX/meta.json   — tree description, shapes, dtypes, step
  step_XXXXXXXX/arrays/<i>.npy — one file per leaf

Leaves are numbered in the reference's ``jax.tree.flatten`` order (dict
keys sorted, tuple / NamedTuple fields in order: ``tree.tree_leaves``),
so either package restores what the other wrote.  bfloat16 leaves are
written widened to float32 (exact; the reference's restore narrows them
back exactly), and a bfloat16 ``.npy`` the reference wrote (ml_dtypes,
which numpy alone loads as 2-byte void) is read as its raw 16-bit
words.  Atomicity: writes go to ``<dir>.tmp`` and are renamed on
completion, so a crash mid-save never corrupts the latest checkpoint;
``latest_step`` only sees committed directories.  Restore places each
leaf on its target's device and, given ``shardings`` and a mesh, makes
it a DTensor under them: the reference's elastic re-shard (arrays saved
under any mesh, or none, re-placed under the current one).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.training.tree import tree_leaves, tree_unflatten


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return (f"{type(tree).__name__}("
                + ", ".join(_describe(t) for t in tree) + ")")
    return "None" if tree is None else "*"


def _tree_meta(tree) -> dict:
    leaves = tree_leaves(tree)
    return {
        "treedef": _describe(tree),
        "n_leaves": len(leaves),
        "shapes": [list(t.shape) for t in leaves],
        "dtypes": [str(t.dtype).removeprefix("torch.") for t in leaves],
    }


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_checkpoint(ckpt_dir: str | Path, step: int, tree,
                    extra: Optional[dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    for i, leaf in enumerate(tree_leaves(tree)):
        np.save(tmp / "arrays" / f"{i}.npy", _to_numpy(leaf))
    meta = _tree_meta(tree)
    meta["step"] = step
    meta["extra"] = extra or {}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 words
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(ckpt_dir: str | Path, step: int, target_tree,
                       shardings=None, mesh=None):
    """Restore into the structure of ``target_tree``: each leaf in its
    target's dtype and on its target's (local) device.  Returns (tree,
    meta).

    ``shardings``: a tree of the target's structure holding placement
    tuples or ``P`` specs (``param_shardings``, ``param_pspecs``,
    ``opt_pspecs``, ...), with ``mesh`` the ``DeviceMesh`` they refer
    to: each leaf is then a DTensor placed by them (every rank reads the
    whole array and keeps its shard).
    """
    if (shardings is None) != (mesh is None):
        raise ValueError("restore_checkpoint: shardings and mesh go "
                         "together")
    path = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((path / "meta.json").read_text())
    leaves = tree_leaves(target_tree)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                         f"target {len(leaves)}")
    out = []
    for i, ref in enumerate(leaves):
        t = _from_numpy(np.load(path / "arrays" / f"{i}.npy"))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: saved {tuple(t.shape)} != target "
                             f"{tuple(ref.shape)}")
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    tree = tree_unflatten(target_tree, out)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute_tree
        tree = distribute_tree(tree, shardings, mesh)
    return tree, meta
