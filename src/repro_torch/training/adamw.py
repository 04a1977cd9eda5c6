"""Mixed-precision AdamW (PyTorch port of ``repro.training.adamw``).

Keeps fp32 master weights and fp32 first / second moments; the model
parameters stay in the model dtype (bf16) and are re-cast from the
masters every step.  The update runs in place: masters, moments, the
step count and the parameters are overwritten (the reference's jitted
train step donates them), so a full-size state is never held twice.
Global-norm clipping stays on the device (no host sync).

On DTensors (a ``DeviceMesh``, the state placed by ``opt_pspecs``:
ZeRO-1) each gradient first takes its master's placement
(``place_grads``: a partial sum over "data" is reduce-scattered, a
replicated one sliced); the update then runs the unmeshed path's
arithmetic on every rank's local shards, and each parameter is cast
from its master shard and all-gathered back to its own placement.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels._build import is_dtensor
from repro_torch.training.tree import tree_leaves, tree_map

f32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    master: Any  # fp32 parameter copies
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    """fp32 masters (copies, also of fp32 parameters) and zero moments
    on the parameters' device."""
    some = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        master=tree_map(lambda p: p.detach().to(f32, copy=True), params),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                          device=p.device), params),
    )


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, on the device
    (of DTensor leaves: a plain tensor, the same on every rank)."""
    leaves = tree_leaves(grads)
    if leaves and is_dtensor(leaves[0]):
        return torch.sqrt(_sharded_square_sum(leaves))
    return torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                          for g in leaves))


def _sharded_square_sum(leaves):
    """The sum of DTensor leaves' squares: local sums, added within each
    set of leaves sharded on the same mesh dims, each set's sum reduced
    over those dims alone (a replica is counted once).  A partial sum is
    reduced first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    sums: dict = {}
    for g in leaves:
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, [
                Replicate() if p.is_partial() else p for p in g.placements])
        key = (g.device_mesh, tuple(p.is_shard() for p in g.placements))
        sq = torch.sum(torch.square(g.to_local().to(f32)))
        sums[key] = sq if key not in sums else sums[key] + sq
    return sum(DTensor.from_local(s, mesh, [
        Partial() if sharded else Replicate() for sharded in key],
        run_check=False).full_tensor() for (mesh, key), s in sums.items())


def place_grads(grads, state: AdamWState):
    """``grads`` in the placements of ``state``'s masters (on DTensors:
    a partial sum is reduced, onto the shards where the master is
    sharded; a replica is sliced); ``grads`` itself off a mesh."""
    if not is_dtensor(state.step):
        return grads

    def one(g, m):
        if tuple(g.placements) == tuple(m.placements):
            return g
        return g.redistribute(m.device_mesh, m.placements)
    return tree_map(one, grads, state.master)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """Returns (params, state), both updated in place.  Global-norm
    clipping included; the bias correction and the decoupled weight
    decay are the reference's, in its order of operations."""
    with torch.profiler.record_function("adamw_update"):
        return _update(grads, state, params, lr, b1, b2, eps, weight_decay,
                       grad_clip)


def _update(grads, state, params, lr, b1, b2, eps, weight_decay,
            grad_clip):
    sharded = is_dtensor(state.step)
    if sharded:
        grads = place_grads(grads, state)
        step = state.step.to_local().add_(1)
    else:
        step = state.step.add_(1)
    scale = torch.clamp(grad_clip / torch.clamp_min(global_norm(grads),
                                                    1e-12), max=1.0)
    c1 = 1.0 - b1 ** step.to(f32)
    c2 = 1.0 - b2 ** step.to(f32)
    for g, m, v, master, p in zip(*(tree_leaves(t) for t in (
            grads, state.mu, state.nu, state.master, params))):
        if not sharded:
            _leaf_update(g, m, v, master, scale, c1, c2, lr, b1, b2, eps,
                         weight_decay)
            p.copy_(master)
            continue
        _leaf_update(g.to_local(), m.to_local(), v.to_local(),
                     master.to_local(), scale, c1, c2, lr, b1, b2, eps,
                     weight_decay)
        _copy_gathered(p, master)
    return params, state


def _leaf_update(g, m, v, master, scale, c1, c2, lr, b1, b2, eps,
                 weight_decay):
    """One leaf's AdamW step on plain tensors, in place."""
    g = g.to(f32) * scale
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * torch.square(g))
    del g
    upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
    upd.add_(weight_decay * master)
    master.sub_(upd.mul_(lr))


def _copy_gathered(p, master):
    """DTensor ``p`` <- ``master`` cast to ``p``'s dtype on its shards,
    then moved to ``p``'s placements (an all-gather over "data" in
    ZeRO-1)."""
    from torch.distributed.tensor import DTensor
    src = DTensor.from_local(master.to_local().to(p.dtype),
                             master.device_mesh, master.placements,
                             run_check=False)
    if tuple(src.placements) != tuple(p.placements):
        src = src.redistribute(p.device_mesh, p.placements)
    p.to_local().copy_(src.to_local())
