"""Decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention``.  The
kernel is ``csrc/decode_attention.cu``: one launch that splits the cache
axis across blocks and folds the splits' combine in (its header says
what bounds it on the H100 and how); ``decode_attention_plain`` computes
the same function in plain PyTorch, as ``repro.kernels.ref`` does in
jnp.

``decode_attention`` runs the plain version on a CPU tensor (and on a
``meta`` tensor, shapes only, for the dry-run) and launches the kernel
on a CUDA tensor; there is no other switch and no fallback.  A DTensor
never reaches it whole: ``ops`` hands it local shards.
Decode serves only: it has no backward, and raises when grad is enabled
and an input requires grad.  Which of the source's two kernels a launch
takes follows from (dtype, head_dim) alone (``instance``): bf16 at
head_dim 64, 128 and 256 runs ``decode_mma`` (tensor cores, a cp.async
ring); fp32 at every head_dim and bf16 at 16 and 32 run ``decode_simt``
(fp32 on the CUDA cores).  ``decode_attention.launches`` counts kernel
launches, one a call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIMS,
                                                 rows_aligned)

NEG_INF = -1e30
MAX_GROUP = 16     # query heads per kv head the kernel holds (G <= 16)
TILE = 32          # slots per kernel tile; a split is a multiple of it
SMS = 132          # the H100's streaming multiprocessors
MAX_SPLIT = 128    # splits per (b, kv-head) the kernel's combine takes
MMA_HEAD_DIMS = (64, 128, 256)  # bf16 head dims on the tensor cores

_workspace: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def instance(dtype, hd) -> str:
    """The kernel a CUDA launch takes: ``"mma"`` (bf16 at head_dim 64,
    128, 256: tensor cores) or ``"simt"`` (every other supported case)."""
    return ("mma" if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS
            else "simt")


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


@functools.lru_cache(maxsize=256)
def split_plan(batch_kv: int, S: int, hd: int, itemsize: int,
               G: int) -> tuple[int, int]:
    """(chunk, n_split): slots per split block and the number of splits.

    Sized by bytes: each block gets about 1/SMS of the call's k and v
    (whole 32-slot tiles), so one wave of blocks covers the card with
    every block's share in flight at once.  The folded combine then
    reads n_split * G * hd fp32 partials of a (b, kv-head) on one SM
    while a block reads chunk * hd of k and v: a split takes at least
    sqrt(G * S / 2) slots, which keeps the first within about twice the
    second.  At most MAX_SPLIT splits.
    """
    tiles = -(-S // TILE)
    tile_bytes = 2 * TILE * hd * itemsize
    per_block = -(-batch_kv * tiles * tile_bytes // SMS)
    n_tiles = max(1, -(-per_block // tile_bytes), -(-tiles // MAX_SPLIT),
                  -(-math.isqrt(G * S // 2) // TILE))
    chunk = min(tiles, n_tiles) * TILE
    return chunk, -(-S // chunk)


def decode_attention(q, k, v, q_pos, kv_pos, *, window=None, softcap=None):
    """One-token GQA attention over a cached KV.

    q: (B, K, G, hd) — the G query heads per kv head; k, v: (B, K, S, hd)
    cache; q_pos: (B,) int32 current positions; kv_pos: (B, S) int32
    absolute positions per slot (-1 = empty).  Returns (B, K, G, hd).
    On CUDA the inputs may be strided views with a contiguous last dim
    (the model passes its (B, S, K, hd) cache transposed, not copied).
    """
    _build.check_no_grad("decode_attention", q, k, v)
    if q.device.type in _build.PLAIN_DEVICES:
        return decode_attention_plain(q, k, v, q_pos, kv_pos,
                                      window=window, softcap=softcap)
    B, K, G, hd = q.shape
    S = k.shape[2]
    _check(q, k, v, q_pos, kv_pos)
    chunk, n_split = split_plan(B * K, S, hd, q.element_size(), G)
    o = torch.empty_like(q)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    ticket, part = _scratch(q.device, stream, B * K,
                            B * K * n_split * G * (hd + 2))
    strides = (ctypes.c_int64 * 14)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *kv_pos.stride(),
                                    *o.stride()[:3])
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:  # first call on this library
        fn.argtypes = [_build.P] * 8 + [_build.I32] * 8 + [
            ctypes.POINTER(ctypes.c_int64), _build.I32, _build.F32,
            _build.F32, _build.I32, _build.P]
        fn.restype = _build.I32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), o.data_ptr(), part.data_ptr(),
             ticket.data_ptr(), DTYPES[q.dtype], hd, B, K, G, S, chunk,
             n_split, strides, int(window or 0), float(softcap or 0.0),
             hd ** -0.5, q.device.index, stream)
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return o


def _scratch(device, stream, n_pairs, n_part):
    """The ticket counters (int32, zeroed once; the kernel leaves them at
    0) and partials buffer (fp32) of one (device, stream), grown as calls
    need.  Kept across calls: calls on one stream run in order, so they
    reuse them safely; calls on two streams of a device, which may
    overlap, get a set each."""
    key = (device.index, stream)
    ticket, part = _workspace.get(key, (None, None))
    if ticket is None or ticket.numel() < n_pairs:
        ticket = torch.zeros((max(n_pairs, 64),), dtype=torch.int32,
                             device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty((max(n_part, 1 << 16),), dtype=torch.float32,
                           device=device)
    _workspace[key] = (ticket, part)
    return ticket, part


def take_scratch(device, stream):
    """Remove the scratch set of (device, stream) and hand it to the
    caller (None if that stream has none): a CUDA graph that captured
    calls on ``stream`` owns the set its replays address, so no later
    call on that stream writes into it."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return _workspace.pop((index, stream), None)


decode_attention.launches = 0


def _check(q, k, v, q_pos, kv_pos):
    _build.check_local("decode_attention", q, k, v, q_pos, kv_pos)
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
    check_rows_aligned(q, k, v)


def check_rows_aligned(q, k, v):
    """Raise ValueError unless the rows the chosen kernel loads in
    16-byte units start on 16-byte boundaries: k's and v's, and q's
    where the instance is ``"mma"`` (its producer copies q with
    cp.async; the CUDA-core kernel reads q element by element)."""
    kind = instance(q.dtype, q.shape[-1])
    names = {"q": q, "k": k, "v": v} if kind == "mma" else {"k": k, "v": v}
    bad = [n for n, t in names.items() if not rows_aligned(t)]
    if bad:
        raise ValueError(f"decode_attention: rows of {', '.join(bad)} must "
                         f"start on 16-byte boundaries (the {kind} kernel "
                         f"loads {', '.join(names)} in 16-byte units)")
