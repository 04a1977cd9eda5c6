"""Step functions (PyTorch port of ``repro.training.step``).

``make_train_step`` builds the train step:
    grads = autograd.grad(loss); AdamW update; metrics
with optional microbatch gradient accumulation (a loop over
microbatches, fp32 sums) and optional int8 gradient compression (see
compress.py).

``make_serve_steps`` builds (prefill_fn, decode_fn) for the serving
shapes; decode is greedy (argmax) one-token generation against the
caller-provided KV / recurrent cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import is_dtensor
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import decode_step, loss_fn, prefill
from repro_torch.models.partition import constrain
from repro_torch.training.adamw import (AdamWState, adamw_update,
                                        global_norm, place_grads)
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

f32 = torch.float32


def make_train_step(cfg: ArchConfig, *, lr=3e-4, accum_steps: int = 1,
                    compress_fn=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the parameters and the optimizer state updated in place
    (see ``adamw_update``).  ``batch``: tensors on the parameters'
    device.  ``metrics``: the loss's metrics (detached; of the last
    microbatch) and ``grad_norm``, tensors on the device (nothing in
    the step syncs with the host).

    accum_steps > 1 splits the batch on its leading dim into that many
    microbatches and sums their grads in fp32, divided by accum_steps:
    the activation-memory lever for large batches.

    On a mesh (parameters and ``opt_state`` as DTensors, the state
    placed by ``opt_pspecs``) the grads take the masters' placements
    before the update (``place_grads``), so ``grad_norm`` and the
    update read each gradient once, reduced.
    """

    def grads_of(params, batch):
        # fresh leaves that share the parameters' storage, so the
        # caller's tensors are not turned into autograd leaves
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return (tree_unflatten(params, list(grads)),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(params, opt_state: AdamWState, batch):
        if accum_steps == 1:
            grads, metrics = grads_of(params, batch)
            grads = place_grads(grads, opt_state)
        else:
            # on a mesh the sums are kept in the masters' placements
            like = opt_state.master if is_dtensor(opt_state.step) \
                else params
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=f32), like)
            for i in range(accum_steps):
                micro = {k: _microbatch(v, accum_steps, i)
                         for k, v in batch.items()}
                g, metrics = grads_of(params, micro)
                g = place_grads(g, opt_state)
                tree_map(lambda a, gg: a.add_(gg.to(f32)), grads, g)
                del g
            grads = tree_map(lambda g: g.div_(accum_steps), grads)
        if compress_fn is not None:
            grads = compress_fn(grads)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        return params, opt_state, metrics

    return train_step


def _microbatch(v, n, i):
    """The i-th of ``n`` microbatches of ``v`` (split on its leading
    dim): rows i*B/n .. (i+1)*B/n - 1; on a DTensor, rows i, i + n, ...,
    so that a batch sharded over ranks splits on each rank's own rows
    (the sum of the microbatches' grads is the same)."""
    if is_dtensor(v):
        return v.reshape((-1, n) + v.shape[1:])[:, i]
    return v.reshape((n, -1) + v.shape[1:])[i]


def make_serve_steps(cfg: ArchConfig, cache_len: Optional[int] = None):
    """(prefill_fn, decode_fn) for serving.

    prefill_fn(params, batch)  -> (next_token, caches)
    decode_fn(params, token, pos, caches) -> (next_token, logits, caches)
    (the caches updated in place).  Under a mesh the logits are sharded
    on batch alone, as the reference's ``out_shardings``.
    """

    @torch.no_grad()
    def prefill_fn(params, batch):
        logits, caches, _ = prefill(
            cfg, params, batch["tokens"], cache_len=cache_len,
            patch_embeds=batch.get("patch_embeds"),
            enc_frames=batch.get("enc_frames"))
        logits = constrain(logits, "batch", None)
        return logits.argmax(-1).to(torch.int32), caches

    @torch.no_grad()
    def decode_fn(params, token, pos, caches):
        logits, caches = decode_step(cfg, params, token, pos, caches)
        logits = constrain(logits, "batch", None)
        nxt = logits.argmax(-1).to(torch.int32)
        return nxt[:, None], logits, caches

    return prefill_fn, decode_fn
