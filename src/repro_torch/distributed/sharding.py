"""Logical-axis sharding rules (PyTorch port of
``repro.distributed.sharding``).

Parameters carry logical axis names from their ``ParamSpec``; this
module resolves them to mesh axes under a rule table, with the
reference's two safety properties:

* a mesh axis is used at most once per array (first logical dim wins);
* a dim is only sharded if its size divides the mesh-axis extent,
  otherwise it is replicated (granite-moe's vocab 49155 and whisper's
  51866 replicate, qwen's and the gemmas' vocabs row-shard).

Specs are the port's per-dim ``P`` (``repro_torch.models.partition``);
``to_placements`` turns one into DTensor placements and
``distribute_tree`` places a tree of tensors by a tree of specs.  The
spec functions read only the mesh's axis sizes (``mesh_sizes``), so they
take a ``DeviceMesh`` or any object whose ``shape`` is a {name: size}
dict.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.model import (_STACKED, _leaves, cache_layout,
                                      model_template)
from repro_torch.models.partition import (MeshAxes, P, mesh_sizes,
                                          to_placements)
from repro_torch.training.adamw import AdamWState
from repro_torch.training.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes)."""
    rules: dict[str, MeshAxes]

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.rules.get(name)


# Default TP-over-"model", DP-over-("pod","data") layout.
DEFAULT_RULES = ShardingRules({
    "batch": ("pod", "data"),
    "vocab": "model",       # row-sharded embeddings / logits
    "embed": None,          # d_model replicated
    "heads": "model",       # fused H*hd projections (always divisible)
    "kv_heads": "model",    # fused K*hd projections
    "ff": "model",          # MLP inner dim
    "experts": "model",     # expert parallelism
    "layers": None,         # stacked-layer dim
    "seq": "model",         # sequence-parallel KV caches (decode)
})


def _axis_size(sizes: dict, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _present(sizes: dict, axes: MeshAxes) -> MeshAxes:
    """Drop mesh axes this mesh lacks (e.g. 'pod' on one pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in sizes else None
    kept = tuple(a for a in axes if a in sizes)
    return kept if kept else None


def resolve_axes(shape, log_axes, rules: ShardingRules, mesh) -> P:
    """Resolve one array's logical axes to a spec."""
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, log_axes):
        axes = _present(sizes, rules.get(name))
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else axes
        if any(a in used for a in tup):
            out.append(None)
            continue
        size = _axis_size(sizes, tup)
        if size <= 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(tup)
        out.append(axes if isinstance(axes, str) else tuple(tup))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _map_template(fn, tmpl):
    return {k: (_map_template(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tmpl.items()}


def param_pspecs(cfg: ArchConfig, mesh,
                 rules: ShardingRules = DEFAULT_RULES):
    """Spec tree mirroring ``init_params``."""
    return _map_template(lambda s: resolve_axes(s.shape, s.axes, rules,
                                                mesh), model_template(cfg))


def param_shardings(cfg: ArchConfig, mesh,
                    rules: ShardingRules = DEFAULT_RULES):
    """Placement tree mirroring ``init_params`` on the ``DeviceMesh``."""
    return _map_template(lambda p: to_placements(p, mesh),
                         param_pspecs(cfg, mesh, rules))


def opt_pspecs(cfg: ArchConfig, mesh,
               rules: ShardingRules = DEFAULT_RULES) -> AdamWState:
    """ZeRO-1 specs for the AdamW state (mirrors ``AdamWState``): each
    fp32 master / mu / nu takes its parameter's spec plus the "data"
    axis on the first still-replicated dim that divides."""
    sizes = mesh_sizes(mesh)
    data = _present(sizes, "data")
    dsize = _axis_size(sizes, data)

    def zero1(s: ParamSpec) -> P:
        spec = resolve_axes(s.shape, s.axes, rules, mesh)
        if data is None or dsize <= 1:
            return spec
        out = list(spec) + [None] * (len(s.shape) - len(spec))
        for i, (dim, cur) in enumerate(zip(s.shape, out)):
            if cur is None and dim % dsize == 0:
                out[i] = data
                break
        return P(*out)

    z = _map_template(zero1, model_template(cfg))
    return AdamWState(step=P(), master=z, mu=z, nu=z)


def batch_pspec(mesh, rules: ShardingRules = DEFAULT_RULES,
                batch_size: Optional[int] = None,
                extra_dims: int = 1) -> P:
    """Batch-leading activation spec: (batch, ...) -> P(dp_axes, ...)."""
    sizes = mesh_sizes(mesh)
    axes = _present(sizes, rules.get("batch"))
    if axes is not None and batch_size is not None:
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        # fall back to fewer axes (or none) when batch doesn't divide
        while tup and batch_size % _axis_size(sizes, tup) != 0:
            tup = tup[1:]
        axes = tup if tup else None
    return P(axes, *([None] * extra_dims))


_SCAN_GROUPS = ("scan", "rem_scan")


def cache_pspecs(cfg: ArchConfig, mesh, batch: int, cache_len: int,
                 rules: ShardingRules = DEFAULT_RULES,
                 stacked: bool = True):
    """Spec tree mirroring ``init_cache``.

    KV caches shard over batch plus one more axis: kv_heads when they
    divide the model axis, otherwise the sequence dim.  Recurrent states
    shard over batch and, where it divides, the channel dim.
    """
    sizes = mesh_sizes(mesh)
    model_size = _axis_size(sizes, _present(sizes, "model"))
    dp = batch_pspec(mesh, rules, batch_size=batch, extra_dims=0)
    dp_axes = dp[0] if len(dp) else None
    kv_on_heads = cfg.n_kv_heads % model_size == 0 if model_size > 1 \
        else False

    def spec_for(path, leaf):
        name, shape = path[-1], leaf[0]
        nd = len(shape)
        # leading layer-stack dim is never a mesh axis
        lead = (None,) if (stacked and nd and any(
            p in _SCAN_GROUPS for p in path)) else ()
        body: list = [None] * (nd - len(lead))
        if body:  # batch, right after the optional stack dim
            body[0] = dp_axes
        seq_divides = model_size > 1 and shape[len(lead) + 1] % \
            model_size == 0 if nd - len(lead) >= 2 else False
        if name in ("k", "v", "cross_k", "cross_v") and \
                nd - len(lead) == 4:
            if kv_on_heads:
                body[2] = "model"
            elif seq_divides:
                body[1] = "model"
        elif name in ("k_scale", "v_scale") and nd - len(lead) == 3:
            if not kv_on_heads and seq_divides:
                body[1] = "model"  # follow the seq-sharded codes
        elif name in ("h", "conv") and nd - len(lead) >= 2:
            if model_size > 1 and shape[-1] % model_size == 0:
                body[-1] = "model"
        # "pos" (B, S) int32 and the other recurrent states: batch only
        return P(*(list(lead) + body))

    def walk(tree, path):
        return {k: (walk(v, path + (k,)) if isinstance(v, dict)
                    else spec_for(path + (k,), v))
                for k, v in tree.items()}

    return walk(cache_layout(cfg, batch, cache_len), ())


def distribute_tree(tree, specs, mesh):
    """``tree``'s tensors as DTensors on ``mesh`` placed by ``specs`` (a
    tree of the same structure holding ``P`` specs or placement tuples).
    Every rank holds the whole tensor (the same seed, or a checkpoint),
    so each keeps its own shard and nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    leaves = tree_leaves(tree)
    spec_leaves = _spec_leaves(specs)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"distribute_tree: {len(leaves)} tensors, "
                         f"{len(spec_leaves)} specs")
    out = []
    for t, s in zip(leaves, spec_leaves):
        placements = s if not isinstance(s, P) else to_placements(s, mesh)
        out.append(distribute_tensor(t, mesh, placements,
                                     src_data_rank=None))
    return tree_unflatten(tree, out)


def distribute_params(params, cfg: ArchConfig, mesh,
                      rules: ShardingRules = DEFAULT_RULES):
    """The parameter tree as DTensors placed by ``param_pspecs``."""
    return distribute_tree(params, param_pspecs(cfg, mesh, rules), mesh)


def _spec_leaves(specs) -> list:
    """The specs (``P``) or placement tuples of a spec tree, in
    ``tree_leaves`` order."""
    from torch.distributed.tensor import Placement
    if isinstance(specs, P) or (type(specs) is tuple and specs and all(
            isinstance(x, Placement) for x in specs)):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, (tuple, list)):
        return [x for t in specs for x in _spec_leaves(t)]
    raise TypeError(f"not a spec: {specs!r}")


def _local_index(shape, placements, mesh) -> list[tuple[int, int]]:
    """(first index, length) along each dim of this rank's shard of a
    tensor of global ``shape`` under ``placements`` (even shards; a dim
    sharded on several mesh dims splits in mesh order, as DTensor's)."""
    coord = mesh.get_coordinate()
    idx, n = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            idx[p.dim] = idx[p.dim] * mesh.size(i) + coord[i]
            n[p.dim] //= mesh.size(i)
    return [(i * m, m) for i, m in zip(idx, n)]


def _put(dst, index, src, layer=None):
    """Copy the part of ``src`` (a whole leaf, or its stacked slice
    ``layer``) that ``index`` holds into the local shard ``dst``."""
    if layer is not None:
        (lo, n), index = index[0], index[1:]
        if not lo <= layer < lo + n:
            return
        dst = dst[layer - lo]
    dst.copy_(src[tuple(slice(lo, lo + n) for lo, n in index)])


def init_sharded_state(cfg: ArchConfig, mesh, generator: torch.Generator,
                       device="cuda", *, optimizer: bool = True,
                       rules: ShardingRules = DEFAULT_RULES):
    """Random parameters, and with ``optimizer`` their AdamW state,
    built straight into their placements on ``mesh``: parameters by
    ``param_pspecs``, fp32 masters and zero moments by ``opt_pspecs``
    (ZeRO-1).  Returns (params, AdamWState or None), DTensors whose
    values are those of ``init_params(cfg, generator)`` (and of
    ``adamw_init`` of them) with the same seed: leaves are drawn in
    ``init_params``' order from one generator, a stacked weight one layer
    slice at a time, and each rank keeps its shards of every slice.  So
    no rank holds more than one unsharded slice beside its shards (the
    counterpart of the reference's ``init_params`` / ``adamw_init`` under
    ``out_shardings``)."""
    from torch.distributed.tensor import DTensor, Replicate
    pspecs = dict(_leaves(param_pspecs(cfg, mesh, rules)))
    ospecs = dict(_leaves(opt_pspecs(cfg, mesh, rules).master)) \
        if optimizer else {}

    def shard(spec, shape, dtype):
        placements = to_placements(spec, mesh)
        index = _local_index(shape, placements, mesh)
        local = torch.empty([n for _, n in index], dtype=dtype,
                            device=device)
        return local, index, placements

    def build(tmpl, stacked, path=""):
        # init_params' walk: template order, a stacked leaf slice by slice
        params, masters = {}, {}
        for k, s in tmpl.items():
            if isinstance(s, dict):
                params[k], masters[k] = build(
                    s, stacked or f"{path}{k}" in _STACKED, f"{path}{k}/")
                continue
            targets = [shard(pspecs[path + k], s.shape, cfg.tdtype)]
            if optimizer:
                targets.append(shard(ospecs[path + k], s.shape,
                                     torch.float32))
            if stacked:
                inner = ParamSpec(s.shape[1:], s.axes[1:], s.init, s.scale)
                for layer in range(s.shape[0]):
                    src = torch.empty(s.shape[1:], dtype=cfg.tdtype,
                                      device=device)
                    inner.fill_(src, generator)
                    for local, index, _ in targets:
                        _put(local, index, src, layer)
            else:
                src = torch.empty(s.shape, dtype=cfg.tdtype, device=device)
                s.fill_(src, generator)
                for local, index, _ in targets:
                    _put(local, index, src)
            del src
            params[k], *rest = (DTensor.from_local(
                local, mesh, placements, run_check=False)
                for local, _, placements in targets)
            if rest:
                masters[k] = rest[0]
        return params, masters

    params, masters = build(model_template(cfg), False)
    if not optimizer:
        return params, None

    def zeros(m):
        return DTensor.from_local(torch.zeros_like(m.to_local()), mesh,
                                  m.placements, run_check=False)
    step = DTensor.from_local(
        torch.zeros((), dtype=torch.int32, device=device), mesh,
        [Replicate()] * mesh.ndim, run_check=False)
    return params, AdamWState(
        step=step, master=masters,
        mu=tree_unflatten(masters, [zeros(m) for m in tree_leaves(masters)]),
        nu=tree_unflatten(masters, [zeros(m) for m in tree_leaves(masters)]))
