"""Per-layer parity of a meshed model against the unmeshed one.

At full depth, any change of rounding moves random-weight logits by
about as much as a fault would (qwen2.5-32b's 64 layers: four fp32
K-slices 3.2e-2 of the logits' scale, one input element moved by 2**-7
2.6e-2), so an end-to-end logit limit cannot tell the two apart.  Here
each layer is held on its own from the same input instead:

* ``unmeshed_stream`` runs the unmeshed prefill's layers one by one and
  keeps the residual stream: ``xs[l]``, the input of layer ``l``
  (``xs[L]`` the last layer's output), and the final norm + head's
  last-token logits of ``xs[L]``;
* ``meshed_outputs`` feeds each ``xs[l]`` to the meshed layer ``l``
  (placed as the meshed prefill places its residual stream) and yields
  its output gathered whole, then the meshed final norm + head of
  ``xs[L]``;
* ``gap`` compares two outputs by max abs diff over max abs and by the
  share of elements that are not identical.

Within one layer nothing amplifies a rounding, so a row-parallel
product summed in fp32 in another order flips a few bf16 elements,
while partial products rounded to bf16 before their sum (DTensor's own
bf16 matmul, ``bf16_partial_sums``) flip many.  ``k_slice_dot`` is the
(1, n) row-parallel arithmetic on one device: each row-parallel product
summed as ``n`` K-slices, the yardstick a limit is set against.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.partition import (_DotF32, constrain, flat_rows,
                                          mesh_sizes, rows_out, use_mesh)

# Per-layer limits (of each layer's output, and of the head's last-token
# logits): LAYER_RTOL on max abs diff over max abs, LAYER_MISMATCH on the
# share of bf16 elements not identical.  Set from two measurements of
# qwen2.5-32b's (1, 4) arithmetic, B 4 x 512, on card 0 of
# ``mesh_smoke.py``'s phase D1 (``d1_unmeshed``, NVIDIA H100 80GB HBM3 at
# 700 W; every run records them): its 64 layers with the row-parallel
# products as four fp32 K-slices (``k_slice_dot``) moved at most 6.173e-3 /
# 5.259e-2 (layer 0's share; 1.365e-2 at layer 63); with each K-slice's
# product rounded to bf16 (the fault's arithmetic) no layer's share stayed
# below 0.1975 (0.446 at layer 0).
# On four gloo ranks (``tests/test_torch_mesh_train.py``, reduced, CPU)
# the meshed layers are bit-identical and bf16 partial sums flip 0.58 to
# 0.65 of them.  The share limit sits at about twice the K-slices' worst
# and half the fault's least; max abs diff / max abs, which a single
# bf16 step near the largest element moves by up to 7.8e-3, does not tell
# the two apart (the fault's worst 1.170e-2) and bounds the size of a
# departure at about three times the K-slices' worst.
LAYER_RTOL = 2e-2
LAYER_MISMATCH = 0.1


def blocks(cfg, params):
    """(kind, parameters) of every layer of ``params`` in the order
    ``model._run_layers`` drives them (``model.layer_slices``)."""
    for _, _, _, kind, p in M.layer_slices(cfg, params["layers"]):
        yield kind, p


def _block(cfg, kind, p, x):
    B, S, _ = x.shape
    return M._apply_block(p, cfg, kind, x, M._positions(x, B, S))[0]


def _head(cfg, params, x):
    """The prefill's last-token logits of the last layer's output."""
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return M._head(cfg, params, h[:, -1])


@torch.no_grad()
def unmeshed_stream(cfg, params, tokens):
    """(xs, logits): the unmeshed prefill's residual stream, ``xs[l]`` the
    input of layer ``l`` and ``xs[-1]`` the last layer's output, and the
    final norm + head's last-token logits (fp32)."""
    x = M.embed_tokens(cfg, params, tokens)
    B, S = tokens.shape
    x = M._add_pos_embed(cfg, params, x, M._positions(x, B, S))
    xs = [x]
    for kind, p in blocks(cfg, params):
        x = _block(cfg, kind, p, x)
        xs.append(x)
    return xs, _head(cfg, params, x)


@torch.no_grad()
def unmeshed_outputs(cfg, params, xs, dot):
    """Each layer's unmeshed output from ``xs[l]`` with ``layers.dot``
    replaced by ``dot``, then the head of ``xs[-1]`` (as
    ``meshed_outputs`` yields them)."""
    for l, (kind, p) in enumerate(blocks(cfg, params)):
        with dot_as(dot):
            y = _block(cfg, kind, p, xs[l])
        yield l, y
    with dot_as(dot):
        y = _head(cfg, params, xs[-1])
    yield "head", y


@contextlib.contextmanager
def dot_as(dot):
    """A context in which ``layers.dot`` is ``dot``."""
    plain = L.dot
    L.dot = dot
    try:
        yield
    finally:
        L.dot = plain


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@torch.no_grad()
def meshed_outputs(cfg, dparams, mesh, x_at, place):
    """Layer ``l``'s meshed output (gathered whole on every rank) from
    ``x_at(l)``, the unmeshed stream's input of layer ``l`` as a plain
    tensor on every rank, for each layer, then the meshed final norm +
    head's last-token logits of ``x_at(n_layers)``.  ``place(x)`` makes
    the DTensor the meshed prefill starts from (the batch over the mesh
    dims that shard it); the residual stream is constrained as
    ``_run_layers`` constrains it, in the current act mode."""
    def run(l, fn):
        with use_mesh(mesh):
            x = constrain(place(x_at(l)), "batch", "seq", "embed")
            return _whole(fn(x))
    for l, (kind, p) in enumerate(blocks(cfg, dparams)):
        yield l, run(l, lambda x: _block(cfg, kind, p, x))
    yield "head", run(cfg.n_layers, lambda x: constrain(
        _head(cfg, dparams, x), "batch", None))


def gap(got, want) -> dict:
    """``rel``: max abs diff over max abs of ``want``; ``mismatch``: the
    share of elements whose bf16 roundings differ (of a bf16 output, the
    share not identical; fp32 logits are rounded to bf16 first)."""
    b16 = torch.bfloat16
    mismatch = (got.to(b16) != want.to(b16)).float().mean()
    got, want = got.float(), want.float()
    return {"rel": float((got - want).abs().max() / want.abs().max()),
            "mismatch": float(mismatch)}


def within(g: dict) -> bool:
    """Whether a ``gap`` holds ``LAYER_RTOL`` and ``LAYER_MISMATCH``."""
    return g["rel"] <= LAYER_RTOL and g["mismatch"] <= LAYER_MISMATCH


def row_parallel_storages(cfg, params, mesh) -> set:
    """Storage pointers of the (unmeshed) weights whose contracted dim
    ``param_pspecs`` splits over "model" on ``mesh``: the row-parallel
    products of the meshed model."""
    from repro_torch.distributed.sharding import param_pspecs
    specs = dict(M._leaves(param_pspecs(cfg, mesh)))

    def splits(spec, ndim):  # a spec may leave its trailing dims out
        axes = (tuple(spec) + (None,) * ndim)[ndim - 2]
        return axes is not None and "model" in (
            (axes,) if isinstance(axes, str) else axes)
    return {t.untyped_storage().data_ptr() for path, t in M._leaves(params)
            if t.ndim >= 2 and splits(specs[path], t.ndim)}


def k_slice_dot(cfg, params, mesh, partial_dtype=torch.float32):
    """A ``layers.dot`` for the unmeshed ``params`` that runs the (1, n)
    mesh's row-parallel arithmetic on one device, n the "model" ranks of
    ``mesh``: each row-parallel product (``row_parallel_storages``)
    summed as n K-slices in rank order, each slice's product in
    ``partial_dtype`` (fp32: ``dot_f32_sum``; bf16: the fault
    ``bf16_partial_sums`` shows), cast once."""
    n = mesh_sizes(mesh)["model"]
    rows = row_parallel_storages(cfg, params, mesh)
    plain = L.dot

    def dot(x, w):
        if w.untyped_storage().data_ptr() not in rows:
            return plain(x, w)
        k = w.shape[0] // n
        parts = [_DotF32.apply(x[..., i * k:(i + 1) * k].contiguous(),
                               w[i * k:(i + 1) * k].contiguous())
                 .to(partial_dtype) for i in range(n)]
        return sum(parts[1:], parts[0]).to(x.dtype)
    return dot


def bf16_partial_sums():
    """A context in which every ``layers.dot`` is DTensor's own matmul in
    the input dtype: a row-parallel product then rounds each rank's
    partial product to bf16 and sums those (the fault
    ``partition.dot_f32_sum`` repairs), for showing that a parity check
    catches it."""
    return dot_as(lambda x, w: rows_out(torch.matmul(flat_rows(x), w)))
