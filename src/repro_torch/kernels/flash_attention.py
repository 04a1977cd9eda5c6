"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``.  The
kernel is ``csrc/flash_attention.cu`` (its header says what bounds it on
the H100 and how it is laid out); ``flash_attention_plain`` computes the
same function in plain PyTorch, as ``repro.kernels.ref`` does in jnp.

``flash_attention`` runs the plain version on a CPU tensor (and on a
``meta`` tensor, shapes only, for the dry-run) and launches a kernel on
a CUDA tensor; there is no other switch and no fallback.  A DTensor
never reaches it whole: ``ops`` hands it local shards.
It has no backward, so it raises when grad is enabled and an input
requires grad.  ``flash_attention_fn`` is the differentiable call (a
``torch.autograd.Function``): its forward is ``flash_attention`` (the
kernel on the card), its backward ``flash_attention_bwd``, the exact
gradient of the plain version written out in plain tensor ops, chunked
over queries, on both devices.  The reference has no backward Pallas
kernel (its trainer differentiates the einsum path), so the backward
has no kernel yet; ``flash_attention_plain`` stays the yardstick that
the tests differentiate with autograd.
Which of the source's two kernels a launch takes follows from (dtype,
head_dim) alone (``instance``): bf16 at head_dim 64, 128 and 256 runs
``flash_fwd_wgmma`` (tensor cores, TMA); fp32 at every head_dim and bf16
at 16 and 32 stay on ``flash_fwd_simt`` (fp32 on the CUDA cores).
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance(dtype, hd) -> str:
    """The kernel a CUDA launch takes: ``"wgmma"`` (bf16 at head_dim 64,
    128, 256) or ``"simt"`` (every other supported case)."""
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            else "simt")


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None, chunk=0):
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd) with H % K == 0.

    Positions are indices from 0 for both q and k.  Returns (B, H, Sq,
    hd) in q.dtype; scores, softmax and the p.v product are fp32.
    ``chunk`` > 0 computes the scores in blocks of that many query rows
    (each row's softmax is its own, so the result is the same), which
    bounds them to (B, H, chunk, Skv).
    """
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    cq = chunk if 0 < chunk < Sq else Sq
    outs = []
    for s0 in range(0, Sq, cq):
        s1 = min(s0 + cq, Sq)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, s0:s1].float(),
                         kr) * hd ** -0.5
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = torch.arange(s0, s1, device=q.device)[:, None]
        mask = torch.ones((s1 - s0, Skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    chunk=0):
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd) with H % K == 0.

    Returns (B, H, Sq, hd) in q.dtype.  On CUDA the inputs may be any
    strided views whose last dim is contiguous (the model passes its
    (B, S, K, G, hd) activations transposed, not copied), with k's and
    v's rows 16-byte aligned (both kernels load them as 16-byte vectors
    or TMA boxes), and q's too where ``instance`` is ``"wgmma"`` (TMA
    loads q as well); the output takes q's strides.  ``chunk``: the
    plain version's query block (the kernel tiles on its own).
    """
    _build.check_no_grad("flash_attention", q, k, v)
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, chunk=chunk)
    B, H, Sq, hd = q.shape
    _, K, Skv, _ = k.shape
    _check(q, k, v, H, K, hd)
    o = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:  # first call on this library
        fn.argtypes = [_build.P] * 4 + [_build.I32] * 7 + [
            ctypes.POINTER(ctypes.c_int64), _build.I32, _build.I32,
            _build.F32, _build.F32, _build.I32, _build.P]
        fn.restype = _build.I32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             DTYPES[q.dtype], hd, B, H, K, Sq, Skv, strides, int(causal),
             int(window or 0), float(softcap or 0.0), hd ** -0.5,
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, do, *, causal=True, window=None,
                        softcap=None, chunk=0):
    """The gradient (dq, dk, dv) of ``flash_attention_plain`` at (q, k,
    v) for the output gradient ``do``, given its output ``o``; shapes as
    ``flash_attention``'s, results in the inputs' dtypes.

    Plain tensor ops in fp32, over query chunks of ``chunk`` rows (0:
    one chunk), so the score-sized buffers are (B, H, chunk, Skv).  Per
    chunk: recompute P against the keys the mask can keep (causal: up to
    the chunk's last query; window: from its first query's window on),
    dV += P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dO * O)) times the
    softcap's derivative 1 - tanh^2, dQ = dS K * scale, dK += dS^T Q *
    scale, each kv head summing over its G query heads.  This is the
    gradient that ``jax.grad`` takes of the reference's einsum attention.
    """
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    f32 = torch.float32
    q5 = q.reshape(B, K, G, Sq, hd)
    o5 = o.reshape(B, K, G, Sq, hd)
    do5 = do.reshape(B, K, G, Sq, hd)
    kf, vf = k.to(f32), v.to(f32)
    # rowsum(dO * O) = rowsum(P * dP): the softmax's Jacobian term
    dsum = (do5.to(f32) * o5.to(f32)).sum(-1)
    dq = torch.empty((B, K, G, Sq, hd), dtype=f32, device=q.device)
    dk = torch.zeros((B, K, Skv, hd), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    cq = chunk if 0 < chunk < Sq else Sq
    for s0 in range(0, Sq, cq):
        s1 = min(s0 + cq, Sq)
        lo = max(0, s0 - window + 1) if window is not None else 0
        hi = min(Skv, s1) if causal else Skv
        qc, doc = q5[:, :, :, s0:s1].to(f32), do5[:, :, :, s0:s1].to(f32)
        kc, vc = kf[:, :, lo:hi], vf[:, :, lo:hi]
        s = torch.einsum("bkgqd,bktd->bkgqt", qc, kc) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        qp = torch.arange(s0, s1, device=q.device)[:, None]
        kp = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((s1 - s0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        del s
        dv[:, :, lo:hi] += torch.einsum("bkgqt,bkgqd->bktd", p, doc)
        dp = torch.einsum("bkgqd,bktd->bkgqt", doc, vc)
        ds = p.mul_(dp.sub_(dsum[:, :, :, s0:s1, None]))
        del dp
        if softcap is not None:
            ds.mul_(1.0 - t * t)
            del t
        dq[:, :, :, s0:s1] = torch.einsum("bkgqt,bktd->bkgqd", ds,
                                          kc) * scale
        dk[:, :, lo:hi] += torch.einsum("bkgqt,bkgqd->bktd", ds,
                                        qc) * scale
        del ds
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashFn(torch.autograd.Function):
    """flash_attention forward (the kernel on the card), plain chunked
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, chunk):
        o = flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap, chunk=chunk)
        ctx.save_for_backward(q, k, v, o)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      chunk=chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_fn(q, k, v, *, causal=True, window=None, softcap=None,
                       chunk=0):
    """Differentiable ``flash_attention``: the same forward (the kernel on
    a CUDA tensor, the plain version on a CPU tensor) with
    ``flash_attention_bwd`` (query chunks of ``chunk`` rows) as its
    backward."""
    return _FlashFn.apply(q, k, v, causal, window, softcap, chunk)


def _check(q, k, v, H, K, hd):
    _build.check_local("flash_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of "
                         f"{list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if H % K or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")
    check_rows_aligned(q, k, v)


def check_rows_aligned(q, k, v):
    """Raise ValueError unless the rows the chosen kernel loads in
    16-byte units start on 16-byte boundaries: k's and v's, and q's
    where the instance is ``"wgmma"``."""
    kind = instance(q.dtype, q.shape[-1])
    names = {"q": q, "k": k, "v": v} if kind == "wgmma" else {"k": k,
                                                              "v": v}
    bad = [n for n, t in names.items() if not rows_aligned(t)]
    if bad:
        raise ValueError(f"flash_attention: rows of {', '.join(bad)} must "
                         f"start on 16-byte boundaries (the {kind} kernel "
                         f"loads {', '.join(names)} in 16-byte units)")


def rows_aligned(t) -> bool:
    """Whether every row of ``t`` (last dim contiguous) starts on a
    16-byte boundary: its data pointer and its other strides, in bytes,
    are multiples of 16."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * es) % 16 == 0 for st in t.stride()[:-1])
