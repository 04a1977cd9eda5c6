"""Activation sharding constraints (PyTorch port of
``repro.models.partition``).

``constrain(x, *logical_names)`` resolves the names against the current
``DeviceMesh`` (``use_mesh``) and redistributes a DTensor ``x`` to the
placements they give; on a plain tensor, or with no mesh, it returns
``x`` as it is, so every unmeshed path stays bit for bit what it was.
The reference reads JAX's ``with mesh:`` context; torch has none, so the
port keeps its own thread-local mesh.

``act_mode`` switches the sequence rule, as the reference's:
  "dp"  -- activations sharded over batch only (default);
  "sp"  -- the sequence dim additionally over the model axis (sequence
          parallelism for the long train / prefill cells).

``act_spec`` is the spec computation alone, a pure function of (shape,
names, mesh sizes, mode), so a test can hold it against the reference.
``to_placements`` maps a per-dim spec to DTensor placements.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

from repro_torch.kernels._build import is_dtensor

_state = threading.local()

MeshAxes = Union[None, str, tuple[str, ...]]

ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": "model",       # only active in "sp" mode
    "tokens": ("pod", "data", "model"),  # flattened (B*S) token dim
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "layers": None,
    None: None,
}


class P(tuple):
    """A per-dim sharding spec: one entry per tensor dim, each None (not
    sharded), a mesh-axis name, or a tuple of them (the dim split over
    those axes, major first; a tuple of one is its name, as in JAX's
    ``PartitionSpec``); the port's ``PartitionSpec``."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


def act_mode() -> str:
    return getattr(_state, "mode", "dp")


@contextlib.contextmanager
def use_act_mode(mode: str):
    prev = act_mode()
    _state.mode = mode
    try:
        yield
    finally:
        _state.mode = prev


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind ``constrain`` to ``mesh`` in this thread."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def in_this_context(fn):
    """``fn`` run under the mesh and act mode that are current now,
    whichever thread calls it later.  A checkpointed block's forward is
    recomputed inside the backward, and the autograd engine runs a CUDA
    backward on its own device thread (a CPU or meta one on the caller's),
    where this module's thread-local state is unset: without this the
    recompute ran in "dp" mode with no mesh, and ``dot_f32_sum``
    all-reduced the row-parallel partial sums that "sp" reduce-scatters."""
    mesh, mode = current_mesh(), act_mode()

    def run(*args, **kw):
        with use_mesh(mesh), use_act_mode(mode):
            return fn(*args, **kw)
    return run


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` is such a dict (a JAX mesh, a duck mesh in tests)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def act_spec(shape, names, sizes: dict[str, int], mode: str) -> P:
    """The reference's ``constrain`` spec for an array of ``shape`` with
    logical ``names`` under mesh axis ``sizes`` in ``mode``: "seq" only
    in "sp" mode, a mesh axis at most once per array, leading axes
    dropped until the dim divides."""
    used: set[str] = set()
    spec: list = []
    for dim, name in zip(shape, names):
        if name == "seq" and mode != "sp":
            spec.append(None)
            continue
        axes = ACT_RULES.get(name)
        if axes is None:
            spec.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        tup = tuple(a for a in tup if a in sizes and a not in used)
        size = 1
        for a in tup:
            size *= sizes[a]
        while tup and (size <= 1 or dim % size != 0):
            size //= sizes[tup[0]]
            tup = tup[1:]
        if not tup or size <= 1:
            spec.append(None)
            continue
        used.update(tup)
        spec.append(tup[0] if len(tup) == 1 else tup)
    return P(*spec)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a per-dim ``spec``: tensor
    dim d over mesh axes (a, b) is ``Shard(d)`` on a's and on b's mesh
    dim, which DTensor splits in mesh order, so a dim's axes must follow
    the mesh's order (``("pod", "data")`` does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in tup]
        if idx != sorted(idx):
            raise ValueError(f"to_placements: axes {tup} of dim {d} are "
                             f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def constrain(x, *names: Optional[str]):
    """Redistribute DTensor ``x`` to the placements its logical dim names
    resolve to under the current mesh; ``x`` itself on a plain tensor or
    with no mesh."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = act_spec(x.shape, names, mesh_sizes(mesh), act_mode())
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def like(ref, t: torch.Tensor):
    """``t``, a tensor the model builds itself (rope angles, zero states,
    index vectors), made a replicated DTensor on ``ref``'s mesh when
    ``ref`` is a DTensor, so the two can meet in one op; ``t`` as it is
    otherwise."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t.to(ref.device), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def full(shape, fill, dtype, device, mesh, placements):
    """A DTensor of global ``shape`` filled with ``fill`` under
    ``placements`` (even shards), each rank allocating its own shard on
    ``device`` only."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.full(local, fill, dtype=dtype,
                                         device=device), mesh, placements,
                              run_check=False)


def gather_dim(x, d, keep=lambda size: False):
    """DTensor ``x`` with dim ``d`` gathered on every mesh dim that shards
    it (but those where ``keep(mesh dim size)``); ``x`` itself otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    d = d % x.ndim
    placements = tuple(
        Replicate() if p.is_shard(d) and not keep(mesh.size(i)) else p
        for i, p in enumerate(x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


def shard_offset(x, d: int) -> tuple[int, int]:
    """(first index, length) of this rank's shard of DTensor ``x`` along
    dim ``d`` (even shards; DTensor splits a dim over mesh dims in mesh
    order)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    n, lo = x.to_local().shape[d], 0
    for i, p in enumerate(x.placements):
        if p.is_shard(d):
            lo = lo * mesh.size(i) + coord[i]
    return lo * n, n


def lookup(table, idx):
    """``table[idx]`` (rows of an embedding).  On a DTensor table whose
    rows are sharded (the vocab over "model"), each rank gathers the rows
    it holds, zeros for the others, and the partial sums are all-reduced
    over those ranks (the vocab-parallel embedding, written out:
    DTensor's rule for ``index`` moves the whole table, and some torch
    versions have none for an index sharded over two mesh dims)."""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(idx):
        idx = like(table, idx)
    idx_p, out_p = [], []
    for tp, ip in zip(table.placements, idx.placements):
        if tp.is_shard(0):
            idx_p.append(Replicate())
            out_p.append(Partial())
        elif tp.is_shard(1):
            idx_p.append(Replicate())
            out_p.append(Shard(idx.ndim))
        else:
            idx_p.append(ip)
            out_p.append(ip)
    if tuple(idx_p) != tuple(idx.placements):
        idx = idx.redistribute(mesh, idx_p)
    # a table replicated over a mesh dim that splits the indices gets
    # each rank's share of its gradient there: a partial sum
    grad_p = tuple(Partial() if tp.is_replicate() and ip.is_shard() else tp
                   for tp, ip in zip(table.placements, idx_p))
    rows = table.to_local(grad_placements=grad_p)
    i = idx.to_local().long()
    lo, n = shard_offset(table, 0)
    if n == table.shape[0]:
        out = rows[i]
    else:
        i = i - lo
        mine = ((i >= 0) & (i < n))[..., None]
        out = torch.where(mine, rows[i.clamp(0, n - 1)], 0)
    out = _PartialFromLocal.apply(out, mesh, tuple(out_p))
    whole = tuple(Replicate() if p.is_partial() else p for p in out_p)
    return out if whole == tuple(out_p) else out.redistribute(mesh, whole)


def contraction_split(w) -> bool:
    """Whether DTensor ``w`` (K, F) has its K rows split over a mesh dim
    (a row-parallel weight: each rank's product is a partial sum)."""
    return is_dtensor(w) and any(p.is_shard(w.ndim - 2)
                                 for p in w.placements)


def dot_f32_sum(x, w):
    """``x @ w`` for a row-parallel DTensor ``w`` (``contraction_split``)
    in x's dtype, the ranks' partial products summed in fp32: each rank
    multiplies its K-slices with an fp32 result, the partial sums are
    reduced in fp32 onto the residual stream's placement ("batch",
    "seq", "embed" under the current act mode) and only then cast.  The
    reference's einsum with ``preferred_element_type=f32`` reduces
    before its cast the same way; a DTensor matmul in bf16 would round
    every rank's partial product to bf16 and sum those.  ``x`` gets
    ``flat_rows``; a mesh dim that splits w's columns takes DTensor's
    own matmul."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = flat_rows(x)
    mesh = w.device_mesh
    xp, yp, wg = [], [], []
    for xpi, wpi in zip(x.placements, w.placements):
        if wpi.is_shard(0):  # K split: x's last dim alike, partial sums
            xp.append(Shard(x.ndim - 1))
            yp.append(Partial())
            wg.append(wpi)
        elif wpi.is_replicate():  # rows of x split or whole
            keep = xpi if xpi.is_shard(0) else Replicate()
            xp.append(keep)
            yp.append(keep)
            # a replicated w's gradient from split rows: a partial sum
            wg.append(Partial() if keep.is_shard() else wpi)
        else:
            return rows_out(torch.matmul(x, w))
    xp = tuple(xp)
    if tuple(x.placements) != xp:
        x = x.redistribute(mesh, xp)
    y = _PartialFromLocal.apply(
        _DotF32.apply(x.to_local(grad_placements=xp),
                      w.to_local(grad_placements=tuple(wg))), mesh,
        tuple(yp))
    names = ("batch", "seq") + (None,) * (y.ndim - 3) + ("embed",) \
        if y.ndim >= 3 else ("batch", "embed")
    target = to_placements(act_spec(y.shape, names, mesh_sizes(mesh),
                                    act_mode()), mesh)
    y = y.redistribute(mesh, tuple(
        t if p.is_partial() else p for p, t in zip(yp, target)))
    return rows_out(y.to(x.dtype))


class _DotF32(torch.autograd.Function):
    """``x @ w`` of plain tensors with an fp32 result (bf16 products are
    exact in fp32; on the card one GEMM with fp32 output, elsewhere both
    widened); the backward's two products run in x's dtype, as a
    matmul's do."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            y = torch.mm(x2.float(), w.float())
        return y.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = torch.mm(x.reshape(-1, x.shape[-1]).t(),
                      g.reshape(-1, g.shape[-1]))
        return torch.matmul(g, w.t()), gw


class _PartialFromLocal(torch.autograd.Function):
    """``DTensor.from_local`` under placements that may be partial sums,
    whose gradient is each rank's whole one (the sum's derivative with
    respect to each term is 1), not its share of a partial sum."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.placements = mesh, placements
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate
        placements = tuple(Replicate() if p.is_partial() else p
                           for p in ctx.placements)
        return grad.redistribute(ctx.mesh, placements).to_local(), None, None


def flat_rows(x):
    """``x`` ready to have its leading dims flattened into rows (a matmul
    over its last dim does): on a DTensor, a shard of a leading dim but
    the first is gathered (DTensor cannot flatten a sharded dim into the
    one before it).  In "sp" mode that is the sequence dim
    of a batch- and sequence-sharded activation, gathered before its
    projection as sequence parallelism does."""
    if not is_dtensor(x) or x.ndim < 3:
        return x
    return _gather_after_first(x, range(x.ndim - 1))


def rows_out(y):
    """``y``, a matmul's output over ``flat_rows`` rows; on a DTensor its
    gradient gets ``flat_rows`` too (the matmul's backward flattens it)."""
    if not is_dtensor(y) or y.ndim < 3:
        return y
    return _RowsGrad.apply(y)


class _RowsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return flat_rows(g)


def _gather_after_first(x, dims):
    """DTensor ``x`` with its shards of ``dims`` gathered but the first
    dim's (so that the dims flatten into one)."""
    for d in list(dims)[1:]:
        x = gather_dim(x, d)
    return x


def split_last(x, *sizes):
    """``x`` with its last dim split into ``sizes`` (heads, head width).
    A DTensor sharded on that dim keeps the shard on the first new dim
    where the mesh dim's size divides it; where it does not, the dim is
    gathered first (DTensor refuses the uneven split).  Its gradient is
    merged back with ``merge_last``."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-1], *sizes)
    return _SplitLast.apply(x, sizes)


def merge_last(x, n: int):
    """``x`` with its last ``n`` dims merged into one.  On a DTensor the
    shards of the merged dims but the first are gathered first (DTensor
    cannot flatten them), and the gradient is split back with
    ``split_last``."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-n], -1)
    return _MergeLast.apply(x, n)


def _split(x, sizes):
    x = gather_dim(x, -1, keep=lambda n: sizes[0] % n == 0)
    return x.reshape(*x.shape[:-1], *sizes)


def _merge(x, n):
    x = _gather_after_first(x, range(x.ndim - n, x.ndim))
    return x.reshape(*x.shape[:-n], -1)


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes):
        ctx.n = len(sizes)
        return _split(x, sizes)

    @staticmethod
    def backward(ctx, g):
        return _merge(g, ctx.n), None


class _MergeLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.sizes = tuple(x.shape[-n:])
        return _merge(x, n)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.sizes), None
