"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro.kernels.rglru_scan``.  The kernel
is ``csrc/rglru_scan.cu`` (one thread per (batch, channel) walking the
time axis with its state in a register and the next 32 steps' loads in
flight; its header says what bounds it on the H100);
``rglru_scan_plain`` computes the same function in plain PyTorch, with
the semantics of ``repro.kernels.ref.ref_rglru_scan``.

``rglru_scan`` runs the plain version on a CPU tensor and launches the
kernel on a CUDA tensor; there is no other switch and no fallback.
``rglru_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES


def rglru_scan_plain(a, b, h0=None):
    """a, b: (B, S, R); h0: (B, R) or None (zeros).

    Returns h (B, S, R) in a.dtype with h[:, t] = a[:, t] * h[:, t-1] +
    b[:, t], the state carried in fp32.
    """
    B, S, R = a.shape
    h = torch.zeros((B, R), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    a32, b32 = a.float(), b.float()
    out = torch.empty((B, S, R), dtype=a.dtype, device=a.device)
    for t in range(S):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, R) decay and input; h0: (B, R) initial state or None.

    Returns h: (B, S, R) in a.dtype.  On CUDA, a and b must be
    contiguous and of one dtype (float32 or bfloat16); h0 may be any
    dtype (the kernel reads it as fp32).
    """
    if a.device.type == "cpu":
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


def _check(a, b, h0):
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
