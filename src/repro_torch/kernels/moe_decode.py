"""The MoE layer at decode, expert-sparse: the CUDA kernels' wrapper and
their plain version.

Replaces no Pallas kernel: the JAX package leaves the MoE layer to XLA.
At decode, a call has a few rows per expert (``R = G * cap``: 1 at
olmoe-1b-7b's batch of 4), and the batched product of ``moe_apply``
reads every expert's weights for them; the kernels
(``csrc/moe_decode.cu``, whose header says what bounds them and how)
read the weights of the experts that hold a kept slot and no others,
with the dispatch and the combine folded in.  ``moe_decode_plain``
computes the same function in plain PyTorch, one expert at a time.

``moe_decode`` runs the plain version on a CPU tensor and launches the
kernels on a CUDA tensor; there is no fallback.  ``moe_apply`` calls it
where ``takes_kernel`` holds (a CUDA tensor, no DTensor, no gradient,
at most ``R_MAX`` rows per expert) and keeps its batched product
everywhere else: prefill, training, the meshed MoE, the CPU.
``moe_decode.launches`` counts kernel launches, ``LAUNCHES`` a call;
``experts_read(device)`` is the device's count of experts the kernels
read, over every call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, rows_aligned

f32 = torch.float32
# rows per expert up to which moe_apply takes the kernels: the crossover
# against the batched product, both graphed, that kernel_ab.py measures
# (on an H100 the kernels win at 1 and 2 on olmoe-1b-7b and
# granite-moe-1b-a400m and lose at 4 on olmoe; PERF.md)
R_MAX = 2
ROW_INSTANCES = (1, 2, 4, 8)  # the kernels' instances by rows per expert
LAUNCHES = 3       # up, down, combine
SMS = 132          # the H100's streaming multiprocessors
NT = 256           # threads a block (csrc/moe_decode.cu)
MAX_SMEM = 232448  # shared memory a block may use, in bytes

_counters: dict[int, torch.Tensor] = {}


def takes_kernel(rows: int, x, *weights) -> bool:
    """Whether ``moe_apply`` runs the kernels for a call with ``rows``
    rows per expert (``G * cap``) on ``x`` with ``weights``: a CUDA
    tensor, no DTensor, no gradient needed, ``rows <= R_MAX``."""
    ts = (x, *weights)
    return (x.device.type == "cuda"
            and not any(_build.is_dtensor(t) for t in ts)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts))
            and rows <= R_MAX)


def moe_decode_plain(x, top_e, pos, top_p, wi, wo, *, gs, cap):
    """The kernels' function, one expert at a time.  Arguments as
    ``moe_decode``'s.  An expert with no kept slot is not read; each
    token sums its kept slots in the order k = 0..top_k-1, in fp32."""
    N, D = x.shape
    k = top_e.shape[-1]
    top_e, pos, top_p = (t.reshape(N, k) for t in (top_e, pos, top_p))
    keep = pos < cap
    rows = torch.zeros((N, k, D), dtype=f32, device=x.device)
    for e in range(wi.shape[0]):
        t, j = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        g, u = torch.matmul(x[t], wi[e]).chunk(2, dim=-1)  # x.dtype
        h = F.gelu(g.to(f32), approximate="tanh").to(x.dtype) * u
        rows[t, j] = torch.matmul(h.to(f32), wo[e].to(f32))
    y = torch.zeros((N, D), dtype=f32, device=x.device)
    for j in range(k):
        y = torch.where(keep[:, j, None], y + top_p[:, j, None] * rows[:, j],
                        y)
    return y.to(x.dtype)


def moe_decode(x, top_e, pos, top_p, wi, wo, *, gs, cap):
    """The MoE layer's expert products and combine after ``moe_route``.

    x: (N, D) rows; top_e (int64), pos (int32), top_p (fp32): (N / gs,
    gs, k), ``moe_route``'s routing of x in groups of gs, a slot kept
    where pos < cap; wi (E, D, 2F), wo (E, F, D).  Returns y (N, D) in
    x.dtype: each token's kept slots' expert outputs weighted by top_p,
    summed in fp32.  No host sync; scratch comes from ``torch.empty``,
    so a CUDA graph captures the call.
    """
    _build.check_no_grad("moe_decode", x, wi, wo)
    if x.device.type in _build.PLAIN_DEVICES:
        return moe_decode_plain(x, top_e, pos, top_p, wi, wo, gs=gs, cap=cap)
    N, D = x.shape
    E, Fe = wo.shape[0], wo.shape[1]
    k = top_e.shape[-1]
    R = (N // gs) * cap
    _check(x, top_e, pos, top_p, wi, wo, gs, R)
    rt = next(r for r in ROW_INSTANCES if r >= R)
    vec = 16 // x.element_size()
    tn_up, tn_down = tiles(E, N * k, Fe, D, vec)
    h, hout = _scratch(E, R, Fe, D, x.dtype, x.device)
    y = torch.empty_like(x)
    counter = experts_read(x.device)
    lib = _build.load("moe_decode")
    fn = lib.moe_decode_fwd
    if fn.argtypes is None:  # first call on this library
        fn.argtypes = [_build.P] * 10 + [_build.I32] * 13 + [_build.P]
        fn.restype = _build.I32
    err = fn(x.data_ptr(), top_e.data_ptr(), pos.data_ptr(),
             top_p.data_ptr(), wi.data_ptr(), wo.data_ptr(), h.data_ptr(),
             hout.data_ptr(), y.data_ptr(), counter.data_ptr(),
             DTYPES[x.dtype], rt, N, E, k, gs, cap, R, D, Fe, tn_up,
             tn_down, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "moe_decode")
    moe_decode.launches += LAUNCHES
    return y


moe_decode.launches = 0


def tiles(E: int, n_slots: int, Fe: int, D: int, vec: int) -> tuple[int,
                                                                     int]:
    """(tn_up, tn_down): the column tiles of the up kernel (over d_ff)
    and the down kernel (over d_model).  Each starts at 128 bytes a row
    (up: of g and of u) and 256 (down) and halves, down to one 16-byte
    vector, until the experts a call can reach (at most
    ``min(E, n_slots)``) give two blocks per SM."""
    reach = min(E, n_slots)

    def widest(cols, tn):
        while tn > vec and reach * -(-cols // tn) < 2 * SMS:
            tn //= 2
        return tn
    return widest(Fe, 8 * vec), widest(D, 16 * vec)


def _scratch(E, R, Fe, D, dtype, device):
    """The up kernel's h (E, R, F) and the down kernel's fp32 hout
    (E, R, D); only the kept rows are written and read."""
    return (torch.empty((E, R, Fe), dtype=dtype, device=device),
            torch.empty((E, R, D), dtype=f32, device=device))


def experts_read(device) -> torch.Tensor:
    """The device's count of experts the up kernel did not skip, summed
    over every call in the process (int64, one element, on the device).
    Made at the first call, which a CUDA graph's warm-up makes before its
    capture (a count made inside one would be zeroed on every replay)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    c = _counters.get(index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("moe_decode: the expert counter is made by a "
                               "call outside a CUDA graph capture first")
        c = _counters[index] = torch.zeros(1, dtype=torch.int64,
                                           device=device)
    return c


def _check(x, top_e, pos, top_p, wi, wo, gs, R):
    _build.check_local("moe_decode", x, top_e, pos, top_p, wi, wo)
    if x.device.type != "cuda":
        raise ValueError(f"moe_decode: no kernel for {x.device}")
    if not all(t.device == x.device for t in (top_e, pos, top_p, wi, wo)):
        raise ValueError("moe_decode: inputs on different devices")
    if x.dtype not in DTYPES or not (x.dtype == wi.dtype == wo.dtype):
        raise ValueError(f"moe_decode: dtypes {x.dtype}, {wi.dtype}, "
                         f"{wo.dtype}; the kernels take one of "
                         f"{list(DTYPES)}")
    if (top_e.dtype, pos.dtype, top_p.dtype) != (torch.int64, torch.int32,
                                                 f32):
        raise ValueError("moe_decode: top_e int64, pos int32 and top_p "
                         "float32, as moe_route gives them")
    N, D = x.shape
    E, Fe = wo.shape[0], wo.shape[1]
    k = top_e.shape[-1]
    if wi.shape != (E, D, 2 * Fe) or wo.shape != (E, Fe, D) or N % gs \
            or any(t.shape != (N // gs, gs, k) for t in (top_e, pos, top_p)):
        raise ValueError(f"moe_decode: shapes x {tuple(x.shape)}, wi "
                         f"{tuple(wi.shape)}, wo {tuple(wo.shape)}, routing "
                         f"{tuple(top_e.shape)} in groups of {gs}")
    if not all(t.is_contiguous() for t in (x, top_e, pos, top_p, wi, wo)):
        raise ValueError("moe_decode: inputs must be contiguous")
    vec = 16 // x.element_size()
    if Fe % vec or D % vec or not all(rows_aligned(t) for t in (x, wi, wo)):
        raise ValueError(f"moe_decode: d_model {D} and d_ff {Fe} must be "
                         f"multiples of {vec} and x, wi, wo start on "
                         f"16-byte boundaries (16-byte loads)")
    if R > ROW_INSTANCES[-1]:
        raise ValueError(f"moe_decode: {R} rows per expert; the kernels "
                         f"hold at most {ROW_INSTANCES[-1]}")
    rt = next(r for r in ROW_INSTANCES if r >= R)
    if 4 * (8 + max(D, Fe) * rt + NT * vec) > MAX_SMEM:
        raise ValueError(f"moe_decode: d_model {D} / d_ff {Fe} at {rt} rows "
                         f"exceed a block's shared memory")
