"""Meta-device input stand-ins for every (arch, shape) cell (PyTorch port
of ``repro.models.inputs``).

``input_specs`` is the one source of the inputs the dry-run feeds each
cell's step; its tensors live on the ``meta`` device (shapes and dtypes,
no storage).  Decode state comes from ``init_cache(..., device="meta")``
so it can never drift from the model's cache layout.  ``materialize``
turns a spec tree into small real tensors for smoke tests.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.model import init_cache

i32 = torch.int32


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ArchConfig, batch: int):
    s = {}
    if cfg.vision_tokens:
        s["patch_embeds"] = _spec((batch, cfg.vision_tokens, cfg.d_model),
                                  cfg.tdtype)
    if cfg.encoder_layers:
        s["enc_frames"] = _spec((batch, cfg.encoder_seq, cfg.d_model),
                                cfg.tdtype)
    return s


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Inputs for the step function this cell runs.

    train   -> the train step's batch: tokens, labels (+frontends)
    prefill -> prefill(tokens, ...)
    decode  -> decode_step(token, pos, caches): one new token against a
               KV / recurrent cache of seq_len.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        text = S - (cfg.vision_tokens or 0)
        spec = {"tokens": _spec((B, text), i32),
                "labels": _spec((B, text), i32)}
        spec.update(_frontend_specs(cfg, B))
        return spec
    if shape.kind == "prefill":
        text = S - (cfg.vision_tokens or 0)
        spec = {"tokens": _spec((B, text), i32)}
        spec.update(_frontend_specs(cfg, B))
        return spec
    if shape.kind == "decode":
        return {"token": _spec((B, 1), i32),
                "pos": _spec((B,), i32),
                "caches": init_cache(cfg, B, S, device="meta")}
    raise ValueError(shape.kind)


def materialize(spec, seed: int = 0, device="cpu"):
    """Real tensors of a spec tree's shapes and dtypes, drawn from one
    ``torch.Generator`` seeded with ``seed`` (leaves in ``tree_leaves``
    order): integer leaves uniform over [0, 64), float leaves standard
    normal cast to the leaf's dtype.  Deterministic in ``seed``; JAX's
    draws are not reproduced."""
    from repro_torch.training.tree import tree_leaves, tree_unflatten
    gen = torch.Generator().manual_seed(seed)
    out = []
    for leaf in tree_leaves(spec):
        if leaf.dtype.is_floating_point:
            t = torch.randn(leaf.shape, generator=gen).to(leaf.dtype)
        else:
            t = torch.randint(0, 64, leaf.shape, generator=gen,
                              dtype=leaf.dtype)
        out.append(t.to(device))
    return tree_unflatten(spec, out)
