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
    else ValueError (on a CUDA tensor: a device-side assert, see
    ``_check_positions``).
    """
    B, S, K, G, hd = q.shape
    if positions is not None:
        _check_positions(positions, B, S)
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2)
    o = flash_attention(qh, k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, softcap=softcap)
    return o.transpose(1, 2).reshape(B, S, K, G, hd)


def _check_positions(positions, B, S):
    """positions must be 0..S-1 in every row.  A CPU tensor is compared
    on the host (ValueError); on the card the comparison stays there
    (``torch._assert_async``), so a prefill adds no host sync per
    attention layer and wrong positions still fail loudly, at the next
    sync, as a device-side assert."""
    msg = ("attention_op: the flash kernel needs positions 0..S-1 "
           "(prefill from position 0)")
    if positions.shape != (B, S):
        raise ValueError(msg)
    want = torch.arange(S, device=positions.device, dtype=positions.dtype)
    if positions.device.type == "cpu":
        if not torch.equal(positions, want.expand(B, S)):
            raise ValueError(msg)
    else:
        torch._assert_async((positions == want).all(), msg)


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
