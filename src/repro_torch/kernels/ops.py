"""Model-layout wrappers around the kernels.

The model keeps GQA activations as (B, S, K, G, hd) and caches as
(B, T, K, hd).  These wrappers hand the kernels transposed *views* of
those tensors (the kernels read through strides), so neither the
activations nor the KV cache are copied into kernel layout.  The model's
``attn_apply``, ``attn_decode`` and ``rglru_apply`` call them on every
device: a CUDA tensor launches the kernels, a CPU tensor runs their
plain versions.  Attention and the RG-LRU scan go through the kernels'
``torch.autograd.Function``s, so a loss differentiates through them on
both devices; decode has no backward (serving only).

On DTensors (a model run under a ``DeviceMesh``) each wrapper first
redistributes its inputs, written out here, to placements where the
work is local to a rank (``_local_placements``): batch kept on the mesh
dims that shard it; on the "model" dim the kv heads when they divide it,
else the G query heads with k and v replicated, else nothing (the
RG-LRU scan: its channels, else nothing).  The kernel then runs on the
``to_local()`` shards and its output is wrapped with
``DTensor.from_local`` under those placements.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import is_dtensor
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fn
from repro_torch.kernels.rglru_scan import rglru_scan_fn


def attention_op(q, k, v, *, causal=True, window=None, softcap=None,
                 positions=None, chunk_q=0):
    """q: (B, S, K, G, hd); k, v: (B, T, K, hd) -> (B, S, K, G, hd).

    ``chunk_q``: the query chunk of the backward (0: one chunk), which
    bounds its score buffers to (B, H, chunk_q, T) (and those of the
    plain forward).

    The flash kernel takes positions as indices from 0; ``positions``
    (B, S), when given, must be exactly that (prefill from position 0),
    else ValueError (on a CUDA tensor: a device-side assert, see
    ``_check_positions``).
    """
    if is_dtensor(q):
        from torch.distributed.tensor import Partial
        qp, kvp, bp = _attention_placements(q, k.shape[2], 2, 3)
        mesh = q.device_mesh
        # where q's query heads are split and k, v replicated, each rank's
        # k and v gradients are its heads' share: partial sums
        kv_grad = tuple(Partial() if qp_i.is_shard(3) else p
                        for qp_i, p in zip(qp, kvp))
        o = attention_op(
            _local(q, qp), _local(k, kvp, kv_grad), _local(v, kvp, kv_grad),
            causal=causal, window=window, softcap=softcap, chunk_q=chunk_q,
            positions=None if positions is None else _local(positions, bp))
        return _wrap(o, mesh, qp)
    B, S, K, G, hd = q.shape
    if positions is not None:
        _check_positions(positions, B, S)
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    o = flash_attention_fn(qh, k.transpose(1, 2), v.transpose(1, 2),
                           causal=causal, window=window, softcap=softcap,
                           chunk=chunk_q)
    return o.transpose(1, 2).reshape(B, S, K, G, hd)


def _check_positions(positions, B, S):
    """positions must be 0..S-1 in every row.  A CPU tensor is compared
    on the host (ValueError); on the card the comparison stays there
    (``torch._assert_async``), so a prefill adds no host sync per
    attention layer and wrong positions still fail loudly, at the next
    sync, as a device-side assert.  A meta tensor has no values."""
    msg = ("attention_op: the flash kernel needs positions 0..S-1 "
           "(prefill from position 0)")
    if positions.shape != (B, S):
        raise ValueError(msg)
    if positions.device.type == "meta":
        return
    want = torch.arange(S, device=positions.device, dtype=positions.dtype)
    if positions.device.type == "cpu":
        if not torch.equal(positions, want.expand(B, S)):
            raise ValueError(msg)
    else:
        torch._assert_async((positions == want).all(), msg)


def decode_attention_op(q, k, v, q_pos, kv_pos, *, window=None,
                        softcap=None):
    """q: (B, 1, K, G, hd); k, v: (B, T, K, hd) cache -> (B, 1, K, G, hd).
    On DTensors a cache sharded on its slot axis is gathered first: the
    kernel attends over every slot of its (b, kv-head)."""
    if is_dtensor(q):
        qp, kvp, bp = _attention_placements(q, k.shape[2], 2, 3)
        mesh = q.device_mesh
        o = decode_attention_op(
            _local(q, qp), _local(k, kvp), _local(v, kvp),
            _local(q_pos, bp), _local(kv_pos, bp), window=window,
            softcap=softcap)
        return _wrap(o, mesh, qp)
    o = decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                         q_pos.to(torch.int32), kv_pos.to(torch.int32),
                         window=window, softcap=softcap)
    return o[:, None]


def rglru_op(a, gated, h0=None):
    """Diagonal linear recurrence in model layout (B, S, R)."""
    if is_dtensor(a):
        from torch.distributed.tensor import Shard
        mesh = a.device_mesh
        ap = _local_placements(a, a.shape[2], 2)
        hp = tuple(Shard(1) if p == Shard(2) else p for p in ap)
        h = rglru_op(_local(a, ap), _local(gated, ap),
                     None if h0 is None else _local(h0, hp))
        return _wrap(h, mesh, ap)
    return rglru_scan_fn(a, gated, h0)


# --------------------------------------------------------------------------
# local placements of DTensor inputs
# --------------------------------------------------------------------------

def _is_batch(p) -> bool:
    return p.is_shard(0)


def _local_placements(x, n, dim):
    """Placements of ``x`` for work local to a rank: on each mesh dim
    that shards ``x``'s batch (dim 0), Shard(0); on the "model" dim,
    Shard(``dim``) where its size ``n`` divides the axis (``dim`` None:
    never); Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    out = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        size = mesh.size(i)
        if name == "model" and dim is not None and size > 1 \
                and n % size == 0:
            out.append(Shard(dim))
        elif _is_batch(p) and name != "model":
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return tuple(out)


def _attention_placements(q, K, kv_dim, g_dim):
    """(q's, k's and v's, the positions') placements for attention local
    to a rank: the kv heads on "model" where K divides it, else q's G
    query heads (k and v replicated there), else neither."""
    from torch.distributed.tensor import Replicate, Shard
    G = q.shape[g_dim]
    qp = list(_local_placements(q, K, kv_dim))
    kvp = list(qp)
    bp = list(_local_placements(q, 1, None))
    mesh = q.device_mesh
    for i, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(i)
        if name == "model" and size > 1 and K % size:
            qp[i] = Shard(g_dim) if G % size == 0 else Replicate()
            kvp[i] = Replicate()
    return tuple(qp), tuple(kvp), tuple(bp)


def _local(x, placements, grad_placements=None):
    """The local shard of DTensor ``x`` redistributed to ``placements``;
    its gradient comes back under ``grad_placements`` (default:
    ``placements``)."""
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.to_local(grad_placements=grad_placements)


def _wrap(local, mesh, placements):
    """``local`` as a DTensor under ``placements`` (the shards are even:
    global shape and strides follow from the local ones)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements, run_check=False)
