"""Decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention``.  The
kernel is ``csrc/decode_attention.cu`` (a split pass over the cache and
a combine pass, flash-decoding; its header says what bounds it on the
H100); ``decode_attention_plain`` computes the same function in plain
PyTorch, as ``repro.kernels.ref`` does in jnp.

``decode_attention`` runs the plain version on a CPU tensor and launches
the kernel on a CUDA tensor; there is no other switch and no fallback.
``decode_attention.launches`` counts calls that launched the kernel pair.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

NEG_INF = -1e30
MAX_GROUP = 16     # query heads per kv head the kernel holds (G <= 16)
TILE = 32          # slots per kernel tile; a split is a multiple of it
TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def decode_attention_plain(q, k, v, q_pos, kv_pos, *, window=None,
                           softcap=None):
    """q: (B, K, G, hd); k, v: (B, K, S, hd); q_pos: (B,);
    kv_pos: (B, S) (-1 = empty).  Returns (B, K, G, hd) in q.dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) * hd ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        valid &= kv_pos > (q_pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, v.float()).to(q.dtype)


def split_plan(batch_kv: int, S: int) -> tuple[int, int]:
    """(chunk, n_split): slots per split block and the number of splits,
    so that about TARGET_BLOCKS blocks cover the (b, kv-head) pairs."""
    want = max(1, -(-TARGET_BLOCKS // batch_kv))
    chunk = -(-S // want)
    chunk = -(-chunk // TILE) * TILE
    return chunk, -(-S // chunk)


def decode_attention(q, k, v, q_pos, kv_pos, *, window=None, softcap=None):
    """One-token GQA attention over a cached KV.

    q: (B, K, G, hd) — the G query heads per kv head; k, v: (B, K, S, hd)
    cache; q_pos: (B,) int32 current positions; kv_pos: (B, S) int32
    absolute positions per slot (-1 = empty).  Returns (B, K, G, hd).
    On CUDA the inputs may be strided views with a contiguous last dim
    (the model passes its (B, S, K, hd) cache transposed, not copied).
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, q_pos, kv_pos,
                                      window=window, softcap=softcap)
    B, K, G, hd = q.shape
    S = k.shape[2]
    _check(q, k, v, q_pos, kv_pos)
    chunk, n_split = split_plan(B * K, S)
    o = torch.empty_like(q)
    part_acc = torch.empty((B * K * n_split * G * hd,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * K * n_split * G * 2,), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_int64 * 14)(
        *(t.stride(i) for t in (q, k, v) for i in range(3)),
        kv_pos.stride(0), kv_pos.stride(1),
        *(o.stride(i) for i in range(3)))
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = [_build.P] * 8 + [_build.I32] * 8 + [
        ctypes.POINTER(ctypes.c_int64), _build.I32, _build.F32, _build.F32,
        _build.I32, _build.P]
    fn.restype = _build.I32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), o.data_ptr(), part_acc.data_ptr(),
             part_ml.data_ptr(), DTYPES[q.dtype], hd, B, K, G, S, chunk,
             n_split, strides, int(window or 0), float(softcap or 0.0),
             hd ** -0.5, q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0


def _check(q, k, v, q_pos, kv_pos):
    B, K, G, hd = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    if not all(t.device == q.device for t in (k, v, q_pos, kv_pos)):
        raise ValueError("decode_attention: inputs on different devices")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of "
                         f"{list(DTYPES)}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise ValueError("decode_attention: q_pos and kv_pos must be int32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if G > MAX_GROUP:
        raise ValueError(f"decode_attention: {G} query heads per kv head; "
                         f"the kernel holds at most {MAX_GROUP}")
    S = k.shape[2]
    if k.shape != (B, K, S, hd) or v.shape != k.shape \
            or q_pos.shape != (B,) or kv_pos.shape != (B, S):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, kv_pos "
                         f"{tuple(kv_pos.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("decode_attention: head_dim must be contiguous")
