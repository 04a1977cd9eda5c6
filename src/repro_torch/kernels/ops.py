"""Model-layout wrappers around the kernels.

The model keeps GQA activations as (B, S, K, G, hd) and caches as
(B, T, K, hd).  These wrappers hand the kernels transposed *views* of
those tensors (the kernels read through strides), so neither the
activations nor the KV cache are copied into kernel layout.  The model's
``attn_apply``, ``attn_decode`` and ``rglru_apply`` call them on every
device: a CUDA tensor launches the kernels, a CPU tensor runs their
plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan


def attention_op(q, k, v, *, causal=True, window=None, softcap=None,
                 positions=None):
    """q: (B, S, K, G, hd); k, v: (B, T, K, hd) -> (B, S, K, G, hd).

    The flash kernel takes positions as indices from 0; ``positions``
    (B, S), when given, must be exactly that (prefill from position 0),
    else ValueError.
    """
    B, S, K, G, hd = q.shape
    if positions is not None:
        want = torch.arange(S, device=positions.device)
        if positions.shape != (B, S) or not torch.equal(
                positions, want.expand(B, S).to(positions.dtype)):
            raise ValueError("attention_op: the flash kernel needs "
                             "positions 0..S-1 (prefill from position 0)")
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    o = flash_attention(qh, k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, softcap=softcap)
    return o.transpose(1, 2).reshape(B, S, K, G, hd)


def decode_attention_op(q, k, v, q_pos, kv_pos, *, window=None,
                        softcap=None):
    """q: (B, 1, K, G, hd); k, v: (B, T, K, hd) cache -> (B, 1, K, G, hd)."""
    o = decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                         q_pos.to(torch.int32), kv_pos.to(torch.int32),
                         window=window, softcap=softcap)
    return o[:, None]


def rglru_op(a, gated, h0=None):
    """Diagonal linear recurrence in model layout (B, S, R)."""
    return rglru_scan(a, gated, h0)
