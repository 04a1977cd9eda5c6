"""Mixed-precision AdamW (PyTorch port of ``repro.training.adamw``).

Keeps fp32 master weights and fp32 first / second moments; the model
parameters stay in the model dtype (bf16) and are re-cast from the
masters every step.  The update runs in place: masters, moments, the
step count and the parameters are overwritten (the reference's jitted
train step donates them), so a full-size state is never held twice.
Global-norm clipping stays on the device (no host sync).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

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
    """sqrt of the sum of every leaf's squares, in fp32, on the device."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                          for g in tree_leaves(grads)))


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
    step = state.step.add_(1)
    scale = torch.clamp(grad_clip / torch.clamp_min(global_norm(grads),
                                                    1e-12), max=1.0)
    c1 = 1.0 - b1 ** step.to(f32)
    c2 = 1.0 - b2 ** step.to(f32)
    for g, m, v, master, p in zip(*(tree_leaves(t) for t in (
            grads, state.mu, state.nu, state.master, params))):
        g = g.to(f32) * scale
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * torch.square(g))
        del g
        upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
        upd.add_(weight_decay * master)
        master.sub_(upd.mul_(lr))
        del upd
        p.copy_(master)
    return params, state
