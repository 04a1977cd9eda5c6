"""Dry-run of every (arch x shape) cell on the production mesh, on the meta
device (PyTorch port of ``repro.launch.dryrun``).

For each cell this starts a fake process group of 256 (or 512) ranks,
builds the production ``DeviceMesh`` on it, makes meta parameters,
optimizer state and inputs (``input_specs``: shapes and dtypes, no
storage) and distributes them by the sharding rules, then runs the
cell's step as rank 0 would -- ``make_train_step`` (with the
reference's ``accum_steps``) or ``make_serve_steps``' prefill or decode,
in "sp" activation mode for train and prefill -- under ``StepCounter``,
a dispatch mode that sees every op on rank 0's local shards:

* ``flops``: FLOPs per device (``torch.utils.flop_counter``'s formulas
  on the local shapes: matmuls and attention products);
* ``bytes_accessed``: each op's local inputs and outputs (views and
  collectives excluded);
* ``memory``: argument and output bytes per device, and the peak of the
  storages the step allocates (``temp_bytes``; the arguments' own
  storages, which AdamW updates in place, are not among them, as XLA's
  temp size leaves out donated arguments);
* ``collectives``: result bytes per device of each functional
  collective DTensor issues, by kind, as the reference's HLO parser
  counts them (``repro/launch/dryrun.py:87-105``).

The reference parses the compiled HLO and multiplies loop bodies by
their trip counts; here every loop runs as Python, so the counts are
loop-aware by construction.  The mLSTM / sLSTM scans (a Python loop over
time, on DTensors) would take hours at 32768 steps, so with
``loop_aware`` (the default) they run their first step and one more
under ``StepCounter.repeat(S - 1)``, which multiplies that step's counts
(``kernels.loops.time_loop``; the plain RG-LRU scan, a loop on local
shards, runs the same way); ``tests/test_torch_distribution.py`` holds this
against the full loop at a small S.  The kernels' wrappers run their
plain versions on meta tensors (shapes only), so attention is counted
as the plain version computes it: every (query, key) pair, in query
chunks of ``attn_chunk_q`` above ``attn_chunk_threshold``.

Results go to ``build/dryrun/<arch>__<shape>__<sp1|mp>__<tag>.json``.
Usage (no card needed):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k [--multi-pod] [--all] [--act-mode sp|dp] \\
        [--accum N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (batch_pspec, distribute_tree,
                                              opt_pspecs, param_pspecs)
from repro_torch.kernels.loops import time_loops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import SHAPES, applicable_shapes, input_specs
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.models.model import init_cache, init_params, param_count
from repro_torch.models.partition import use_act_mode, use_mesh
from repro_torch.training.adamw import adamw_init
from repro_torch.training.step import make_serve_steps, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _collective_kind(func):
    """The reference's name of a functional collective op, or None."""
    ns = func.namespace
    if not ns.startswith(("_c10d_functional", "_dtensor")):
        return None
    name = func._overloadpacket.__name__
    for frag, kind in (("all_gather", "all-gather"),
                       ("all_reduce", "all-reduce"),
                       ("reduce_scatter", "reduce-scatter"),
                       ("all_to_all", "all-to-all"),
                       ("alltoall", "all-to-all")):
        if frag in name:
            return kind
    if name == "broadcast":
        return name
    return None  # wait_tensor, _wrap_tensor_autograd: no traffic


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs
    each new op once on meta tensors of the global shapes to learn the
    output's, which is no rank's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


_PROPAGATION_FILE = "_sharding_prop.py"


class StepCounter(TorchDispatchMode):
    """Counts rank 0's per-device work: FLOPs, bytes accessed, collective
    result bytes by kind and the peak of live storages it saw allocated.

    Ops on DTensors are passed on (``NotImplemented``) so DTensor turns
    them into ops on local shards and collectives, which this mode then
    sees."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_calls = {k: 0 for k in COLLECTIVES}
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._scale = 1
        self._seen = weakref.WeakSet()

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside as if it ran ``n`` times (one step of a
        loop that runs ``n`` identical ones)."""
        prev = self._scale
        self._scale = prev * n
        try:
            yield
        finally:
            self._scale = prev

    def ignore(self, tree):
        """Leave the storages of ``tree``'s tensors (local shards of
        DTensors) out of the live count: they exist before the step, and
        an in-place op on one allocates nothing."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                local = t.to_local() if hasattr(t, "to_local") else t
                self._seen.add(local.untyped_storage())

    def _track(self, out):
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        self.n_ops += 1
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives.setdefault(kind, 0)
            self.collective_calls.setdefault(kind, 0)
            self.collectives[kind] += self._scale * sum(
                _nbytes(t) for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor))
            self.collective_calls[kind] += self._scale
        elif not func.is_view:
            fn = self._flops.get(func._overloadpacket)
            if fn is not None:
                self.flops += self._scale * int(fn(*args, **kwargs,
                                                   out_val=out))
            if not func._overloadpacket.__name__.startswith("empty"):
                self.bytes_accessed += self._scale * _op_bytes(
                    (args, kwargs, out))
        self._track(out)
        return out


def _op_bytes(tree) -> int:
    """Bytes of the tensors an op reads and writes, each storage once (an
    in-place op's output is its input)."""
    seen, n = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            key = id(t.untyped_storage())
            if key not in seen:
                seen.add(key)
                n += _nbytes(t)
    return n


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
               for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def default_accum(cfg: ArchConfig, shape: ShapeSpec, dp: int) -> int:
    """The reference's microbatching of the big train cells (its
    ``dryrun.py:355-365``): 16 (or 8) above 2e10 parameters, 4 above 5e9
    or on a recurrent arch, else 1; at most the batch per data-parallel
    rank (``dp`` ranks), so every microbatch keeps a row on each (the
    reference's 16 for gemma3-27b gave one row a rank on its 16-way data
    axis; on the H100 mesh's 32-way one it is 8)."""
    if shape.kind != "train":
        return 1
    pc = param_count(cfg)
    if pc > 2e10:
        accum = 16 if cfg.vocab > 200_000 else 8
    elif pc > 5e9 or cfg.family == "ssm":
        accum = 4
    else:
        accum = 1
    return max(1, min(accum, shape.global_batch // dp))


def default_act_mode(shape: ShapeSpec) -> str:
    """Sequence-parallel activations for train and prefill, DP for
    decode (one-token steps), as the reference's sweep."""
    return "sp" if shape.kind in ("train", "prefill") else "dp"


def _batch(spec_tree, mesh, B):
    """Inputs batch-sharded on their leading dim."""
    def one(t):
        return distribute_tree({"x": t}, {"x": batch_pspec(
            mesh, batch_size=B, extra_dims=t.ndim - 1)}, mesh)["x"]
    return {k: one(v) for k, v in spec_tree.items()}


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               accum_steps: int = 1):
    """(step, args): the cell's step function and its meta DTensor
    arguments on ``mesh``."""
    B = shape.global_batch
    specs = input_specs(cfg, shape)
    params = distribute_tree(init_params(cfg, None, device="meta"),
                             param_pspecs(cfg, mesh), mesh)
    if shape.kind == "train":
        opt = distribute_tree(adamw_init(init_params(cfg, None, "meta")),
                              opt_pspecs(cfg, mesh), mesh)
        return (make_train_step(cfg, accum_steps=accum_steps),
                (params, opt, _batch(specs, mesh, B)))
    prefill_fn, decode_fn = make_serve_steps(cfg)
    if shape.kind == "prefill":
        return prefill_fn, (params, _batch(specs, mesh, B))
    caches = init_cache(cfg, B, shape.seq_len, "meta", mesh=mesh)
    tok = _batch({"token": specs["token"], "pos": specs["pos"]}, mesh, B)
    return decode_fn, (params, tok["token"], tok["pos"], caches)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0; collectives return at once), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod=False, act_mode=None,
             accum_steps=None, overrides=None, shape=None, mesh_shape=None,
             loop_aware=True, tag="baseline", save=True) -> dict:
    """Run one cell on the meta device under ``StepCounter``; returns the
    reference's JSON keys (and writes them under ``RESULTS_DIR``).
    ``shape`` (a ``ShapeSpec``) and ``mesh_shape`` / ``overrides``
    replace the cell's shape, the production mesh and config fields
    (tests run reduced configs on small meshes)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = shape or SHAPES[shape_name]
    act_mode = act_mode or default_act_mode(shape)
    if mesh_shape is None:
        n_dev = 512 if multi_pod else 256
    else:
        n_dev = 1
        for d in mesh_shape:
            n_dev *= d
    counter = StepCounter()
    t0 = time.time()
    with fake_world(n_dev):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod)
        else:
            from repro_torch.launch.mesh import make_debug_mesh
            axes = ("pod", "data", "model")[-len(mesh_shape):]
            mesh = make_debug_mesh(mesh_shape, axes)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        accum_steps = accum_steps or default_accum(
            cfg, shape, sizes.get("pod", 1) * sizes.get("data", 1))
        fn, args = build_cell(cfg, shape, mesh, accum_steps=accum_steps)
        arg_bytes = _local_bytes(args)
        t_build = time.time() - t0
        loops = time_loops(counter.repeat if loop_aware else None)
        counter.ignore(args)
        with use_mesh(mesh), use_act_mode(act_mode), loops, counter:
            out = fn(*args)
        t_run = time.time() - t0 - t_build
        out_bytes = _local_bytes(out)
    del out, args
    coll = dict(counter.collectives)
    coll["total"] = sum(counter.collectives.values())
    coll["calls"] = dict(counter.collective_calls)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(sizes.values()),
        "mesh_axes": list(sizes.keys()),
        "n_devices": n_dev,
        "multi_pod": multi_pod,
        "act_mode": act_mode,
        "accum_steps": accum_steps,
        "overrides": overrides or {},
        "tag": tag,
        "kind": shape.kind,
        "param_count": param_count(cfg),
        "loop_aware": loop_aware,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": counter.peak},
        "cost": {"flops": counter.flops,
                 "bytes_accessed": counter.bytes_accessed,
                 "ops": counter.n_ops},
        "collectives": coll,
    }
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        pod = "mp" if multi_pod else "sp1"
        out_path = RESULTS_DIR / f"{arch}__{shape_name}__{pod}__{tag}.json"
        out_path.write_text(json.dumps(result, indent=2))
    return result


def cells(archs=None):
    for arch in archs or ARCH_IDS:
        for shape_name in applicable_shapes(get_config(arch)):
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every applicable (arch, shape) cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--act-mode", default=None, choices=["dp", "sp"])
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        todo = list(cells([args.arch] if args.arch else None))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch, shape_name in todo:
        for mp in meshes:
            pod = "mp" if mp else "sp1"
            out = RESULTS_DIR / f"{arch}__{shape_name}__{pod}__{args.tag}.json"
            if args.skip_done and out.exists():
                print(f"[skip] {arch} {shape_name} {pod}")
                continue
            try:
                r = run_cell(arch, shape_name, multi_pod=mp,
                             act_mode=args.act_mode,
                             accum_steps=args.accum, tag=args.tag)
            except Exception as e:  # report the cell, go on to the next
                failures.append((arch, shape_name, mp, repr(e)))
                traceback.print_exc()
                print(f"[FAIL] {arch} {shape_name} {pod}: {e!r}",
                      flush=True)
                continue
            print(f"[ok] {arch} {shape_name} {pod} "
                  f"wall={r['build_s'] + r['run_s']:.1f}s "
                  f"flops={r['cost']['flops']} "
                  f"temp={r['memory']['temp_bytes']} "
                  f"coll={r['collectives']['total']}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + "; ".join(f"{a}/{s}" for a, s, *_ in failures))
    print("dry-run complete")


if __name__ == "__main__":
    main()
