"""int8 gradient compression (PyTorch port of
``repro.training.compress``): per-tensor-scaled int8 quantization, with
error feedback, and an int8 all-reduce.

* ``simulate_int8`` — stateless quantize -> dequantize of every leaf,
  the numerics of an int8 wire format inside one process.
* ``int8_allreduce`` — the port of ``shard_map_int8_allreduce``: each
  rank quantizes its gradient against the group's max scale (one
  all-reduce MAX of an fp32 scalar per tensor), the int32 codes are
  summed by an all-reduce (exact: every rank used the same scale), and
  the sum is dequantized and divided by the world size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten

f32 = torch.float32


def quantize_int8(x):
    """Per-tensor symmetric int8 quantization.  Returns (q, scale); the
    scale stays on the device (no host sync)."""
    x32 = x.to(f32)
    scale = torch.clamp_min(x32.abs().max() / 127.0, 1e-12)
    return _codes(x32, scale).to(torch.int8), scale


def _codes(x32, scale):
    # torch.round rounds half to even, as jnp.round
    return torch.clamp(torch.round(x32 / scale), -127, 127)


def dequantize_int8(q, scale):
    return q.to(f32) * scale


def make_error_feedback_compressor():
    """Stateful error-feedback int8 compressor: compress(grads, state)
    -> (grads_hat, new_state).  The residual (g - ĝ) is carried and
    added before the next quantization (Karimireddy et al.)."""

    def compress(grads, err_state):
        if err_state is None:
            err_state = tree_map(lambda g: torch.zeros(
                g.shape, dtype=f32, device=g.device), grads)
        pairs = []
        for g, e in zip(tree_leaves(grads), tree_leaves(err_state)):
            g32 = g.to(f32) + e
            ghat = dequantize_int8(*quantize_int8(g32))
            pairs.append((ghat.to(g.dtype), g32 - ghat))
        return (tree_unflatten(grads, [p[0] for p in pairs]),
                tree_unflatten(grads, [p[1] for p in pairs]))

    return compress


def simulate_int8(grads):
    """Stateless quantize -> dequantize of every leaf."""
    return tree_map(lambda g: dequantize_int8(*quantize_int8(g)).to(g.dtype),
                    grads)


def int8_allreduce(grads, group=None):
    """The mean of every rank's ``grads`` through an int8 code sum: per
    leaf, the ranks' max scale (all-reduce MAX), int32 codes against it,
    their all-reduce SUM, dequantized and divided by the world size.
    Conservative shared scale, as the reference's
    ``shard_map_int8_allreduce``."""
    world = dist.get_world_size(group)

    def one(g):
        g32 = g.to(f32)
        _, scale = quantize_int8(g32)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _codes(g32, scale).to(torch.int32)
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return (q.to(f32) * scale / world).to(g.dtype)

    return tree_map(one, grads)
