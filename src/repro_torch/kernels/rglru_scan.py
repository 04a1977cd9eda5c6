"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro.kernels.rglru_scan``.  The kernel
is ``csrc/rglru_scan.cu`` (one thread per (batch, channel) walking the
time axis with its state in a register and the next 32 steps' loads in
flight; its header says what bounds it on the H100);
``rglru_scan_plain`` computes the same function in plain PyTorch, with
the semantics of ``repro.kernels.ref.ref_rglru_scan``.

``rglru_scan`` runs the plain version on a CPU tensor (and on a ``meta``
tensor, shapes only, for the dry-run) and launches the kernel on a CUDA
tensor; there is no other switch and no fallback.  A DTensor never
reaches it whole: ``ops`` hands it local shards.
It has no backward, so it raises when grad is enabled and an input
requires grad.  ``rglru_scan_fn`` is the differentiable call (a
``torch.autograd.Function``): its backward (``rglru_scan_bwd``) is the
reverse-time recurrence g_t = dh_t + a_{t+1} g_{t+1}, run through
``rglru_scan`` itself on time-flipped inputs (the kernel on the card),
then da_t = g_t h_{t-1}, db_t = g_t and dh0 = a_0 g_0.
``rglru_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.loops import time_loop


def rglru_scan_plain(a, b, h0=None):
    """a, b: (B, S, R); h0: (B, R) or None (zeros).

    Returns h (B, S, R) in a.dtype with h[:, t] = a[:, t] * h[:, t-1] +
    b[:, t], the state carried in fp32.
    """
    B, S, R = a.shape
    h = torch.zeros((B, R), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    a32, b32 = a.float(), b.float()

    def step(h, t):
        h = a32[:, t] * h + b32[:, t]
        return h, h
    return time_loop(step, h, S)[1].to(a.dtype)


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, R) decay and input; h0: (B, R) initial state or None.

    Returns h: (B, S, R) in a.dtype.  On CUDA, a and b must be
    contiguous and of one dtype (float32 or bfloat16); h0 may be any
    dtype (the kernel reads it as fp32).
    """
    _build.check_no_grad("rglru_scan", a, b, h0)
    if a.device.type in _build.PLAIN_DEVICES:
        return rglru_scan_plain(a, b, h0)
    B, S, R = a.shape
    _check(a, b, h0)
    h = torch.empty_like(a)
    h0f = None if h0 is None else h0.to(torch.float32).contiguous()
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:  # first call on this library
        fn.argtypes = [_build.P] * 4 + [_build.I32] * 5 + [_build.P]
        fn.restype = _build.I32
    err = fn(a.data_ptr(), b.data_ptr(),
             None if h0f is None else h0f.data_ptr(), h.data_ptr(),
             DTYPES[a.dtype], B, S, R, a.device.index,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0


def rglru_scan_bwd(a, h, h0, dh):
    """The gradient (da, db, dh0) of ``rglru_scan`` at (a, b, h0) given
    its output ``h`` and the output gradient ``dh``; da and db in a's
    dtype, dh0 fp32 (None when h0 is None).  g, the gradient of each
    state, runs backward in time, g_t = dh_t + a_{t+1} g_{t+1}: one more
    ``rglru_scan`` (fp32) over the flipped sequence of (a shifted one
    step, dh)."""
    f32 = torch.float32
    B, S, R = a.shape
    a32 = a.to(f32)
    zero = a32.new_zeros((B, 1, R))
    a_next = torch.cat([a32[:, 1:], zero], dim=1)
    g = rglru_scan(a_next.flip(1), dh.to(f32).flip(1)).flip(1)
    first = zero if h0 is None else h0.to(f32)[:, None]
    h_prev = torch.cat([first, h[:, :-1].to(f32)], dim=1)
    dh0 = None if h0 is None else a32[:, 0] * g[:, 0]
    return (g * h_prev).to(a.dtype), g.to(a.dtype), dh0


class _RglruFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.h0_dtype = None if h0 is None else h0.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(a, h, h0, dh)
        return da, db, None if dh0 is None else dh0.to(ctx.h0_dtype)


def rglru_scan_fn(a, b, h0=None):
    """Differentiable ``rglru_scan`` (same forward; ``rglru_scan_bwd`` as
    its backward, through the kernel on the card)."""
    return _RglruFn.apply(a, b, h0)


def _check(a, b, h0):
    _build.check_local("rglru_scan", a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for {a.device}")
    if b.device != a.device or (h0 is not None and h0.device != a.device):
        raise ValueError("rglru_scan: inputs on different devices")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: dtypes {a.dtype}, {b.dtype}; the "
                         f"kernel takes one of {list(DTYPES)} for both")
    B, S, R = a.shape
    if b.shape != a.shape or (h0 is not None and h0.shape != (B, R)):
        raise ValueError(f"rglru_scan: shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if R == 0 or B == 0:
        raise ValueError("rglru_scan: empty batch or channel axis")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
