"""PyTorch port: the ZeRO-1 sharded train step on a (2, 2) ("data",
"model") mesh of four gloo processes, against the unmeshed port.

One spawn (a module fixture) runs every rank's work and saves it; the
tests read the files:

* ``init_sharded_state`` gives, on every rank, the local shards (values
  and shapes) that ``init_params`` + ``distribute_params`` and
  ``distribute_tree(adamw_init(...), opt_pspecs)`` give, for each
  reduced config;
* three ``make_train_step`` steps of reduced fp32 granite-8b and
  granite-moe-1b-a400m from that state, in "sp" mode, hold the unmeshed
  steps' losses, grad norms, parameters and masters within 2e-4 of each
  leaf's scale (the port's gradient tolerance), and after them the
  masters and moments carry "data" where ``opt_pspecs`` puts it while
  the parameters never do;
* ``int8_allreduce`` over the mesh's "data" sub-group equals the fp32
  mean within one quantization step of the shared scale;
* the fused MLP on a rank's rows that outnumber d_model gathers its
  weight (one all-gather of wi's bytes), not its product, and gives the
  unmeshed values;
* a bf16 ``dot`` with a row-parallel weight sums the ranks' partial
  products in fp32 (as the reference's ``preferred_element_type=f32``
  einsum), so it matches the fp32 product rounded once, where a bf16
  DTensor matmul, rounding each partial sum, does not;
* a reduced bf16 granite-8b ZeRO-1 step in "sp" mode counts the
  collectives ``launch.dryrun.run_cell`` counts for it, also with its
  backward on another thread (as the card runs a CUDA backward);
* ``distributed.parity``'s per-layer check of reduced qwen2.5-32b on a
  (1, 4) mesh passes with the partial sums in fp32 and fails with them
  in bf16.

The unmeshed port is held to the reference by
``tests/test_torch_training.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.partition import use_act_mode, use_mesh  # noqa: E402
from repro_torch.training.adamw import adamw_init  # noqa: E402
from repro_torch.training.compress import int8_allreduce  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

TRAIN_ARCHS = ("granite-8b", "granite-moe-1b-a400m")
# S 64: a rank's 2 x 64 rows outnumber the reduced d_model of 64, so the
# fused MLP gathers its weight, not its product (``layers._gate_up``)
STEPS, B, S, LR = 3, 4, 64, 3e-4
RTOL = 2e-4  # of each leaf's largest magnitude


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _placements(t):
    return tuple(str(p) for p in t.placements)


def _check_init(mesh, rank, out_dir):
    """Each reduced config's sharded state against init_params +
    distribute (exact values, equal local shapes)."""
    bad = []
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        params, opt = TS.init_sharded_state(
            cfg, mesh, torch.Generator().manual_seed(3), "cpu")
        ref = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        want_p = TS.distribute_params(ref, cfg, mesh)
        want_o = TS.distribute_tree(adamw_init(ref),
                                    TS.opt_pspecs(cfg, mesh), mesh)
        pairs = list(zip(tree_leaves(params), tree_leaves(want_p)))
        pairs += list(zip(tree_leaves(opt), tree_leaves(want_o)))
        for got, want in pairs:
            a, b = got.to_local(), want.to_local()
            if (a.shape != b.shape or a.dtype != b.dtype
                    or _placements(got) != _placements(want)
                    or not torch.equal(a, b)):
                bad.append(f"{arch}: {tuple(a.shape)} {a.dtype} "
                           f"{_placements(got)} vs {tuple(b.shape)} "
                           f"{b.dtype} {_placements(want)}")
    np.save(os.path.join(out_dir, f"init-{rank}.npy"), np.array(bad,
                                                                 dtype=str))


def _batch(cfg, seed):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    tok = torch.from_numpy(tok.astype(np.int32))
    return {"tokens": tok[:, :-1].contiguous(),
            "labels": tok[:, 1:].contiguous()}


def _train(mesh, rank, out_dir):
    """STEPS steps unmeshed and on the mesh from the same seed and
    batches; rank 0 saves both, every rank its placements."""
    for arch in TRAIN_ARCHS:
        cfg = get_reduced(arch).with_(dtype="float32")
        step = make_train_step(cfg, lr=LR)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
        opt = adamw_init(params)
        dparams, dopt = TS.init_sharded_state(
            cfg, mesh, torch.Generator().manual_seed(0), "cpu")
        spec = TS.batch_pspec(mesh, batch_size=B, extra_dims=1)
        want, got = [], []
        for i in range(STEPS):
            batch = _batch(cfg, 10 + i)
            params, opt, m = step(params, opt, batch)
            want.append([float(m["loss"]), float(m["grad_norm"])])
            dbatch = TS.distribute_tree(batch, {k: spec for k in batch},
                                        mesh)
            with use_mesh(mesh), use_act_mode("sp"):
                dparams, dopt, dm = step(dparams, dopt, dbatch)
            got.append([float(_whole(dm["loss"])),
                        float(_whole(dm["grad_norm"]))])
        leaves = tree_leaves((params, opt.master))
        dleaves = [_whole(t) for t in tree_leaves((dparams, dopt.master))]
        if rank == 0:
            np.savez(os.path.join(out_dir, f"train-{arch}.npz"),
                     metrics=np.array([want, got]),
                     **{f"want{i}": t.numpy() for i, t in enumerate(leaves)},
                     **{f"got{i}": t.numpy() for i, t in enumerate(dleaves)})
        specs = TS.opt_pspecs(cfg, mesh)
        rows = []
        for p, m, v, n, sp in zip(
                *(tree_leaves(t) for t in (dparams, dopt.master, dopt.mu,
                                           dopt.nu)),
                TS._spec_leaves(specs.master)):
            rows.append((_placements(p), _placements(m), _placements(v),
                         _placements(n), "data" in tuple(sp)))
        with open(os.path.join(out_dir, f"placements-{arch}-{rank}.json"),
                  "w") as f:
            json.dump(rows, f)


def _int8(mesh, rank, out_dir):
    """int8_allreduce over "data" against the fp32 mean of that group,
    and the group's shared scale of each leaf."""
    group = mesh.get_group("data")
    n = dist.get_world_size(group)
    rng = np.random.default_rng(100 + rank)
    grads = {"a": torch.from_numpy(rng.normal(size=(64, 48)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(
            scale=1e-3, size=(1000,)).astype(np.float32))}
    got = int8_allreduce(grads, group=group)
    rows = []
    for k in sorted(grads):
        mean = grads[k].clone()
        dist.all_reduce(mean, group=group)
        mean /= n
        scale = grads[k].abs().max() / 127.0
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        rows.append([float((got[k] - mean).abs().max()), float(scale),
                     float(mean.abs().max())])
    np.save(os.path.join(out_dir, f"int8-{rank}.npy"), np.array(rows))


def _mlp(mesh, rank, out_dir):
    """mlp_apply on B x S rows batch-sharded over "data" (2 x S rows a
    rank, more than d_model) under the dry-run's counter: the all-gather
    result bytes and the output against the unmeshed one."""
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.models import layers as TL
    cfg = get_reduced("granite-8b").with_(dtype="float32")
    p = TM.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    mlp = {k: v[0] for k, v in p["layers"]["scan"]["pos0"]["mlp"].items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    want = TL.mlp_apply(mlp, x)
    specs = {"wi": TS.P(None, "model"), "wo": TS.P("model", None)}
    dmlp = TS.distribute_tree(mlp, specs, mesh)
    dx = TS.distribute_tree({"x": x}, {"x": TS.batch_pspec(
        mesh, batch_size=B, extra_dims=2)}, mesh)["x"]
    with use_mesh(mesh), StepCounter() as counter:
        got = TL.mlp_apply(dmlp, dx)
    got = got.full_tensor()
    np.save(os.path.join(out_dir, f"mlp-{rank}.npy"), np.array([
        float((got - want).abs().max() / want.abs().max()),
        counter.collectives["all-gather"],
        mlp["wi"].numel() * mlp["wi"].element_size()]))


def _row_parallel(mesh, rank, out_dir):
    """A bf16 ``dot`` with a row-parallel weight (rows split over
    "model") against the fp32 product rounded once: the share of
    elements that differ, and DTensor's own bf16 matmul's share."""
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(B, 16, 256)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(256, 64)).astype(
        np.float32)).to(torch.bfloat16)
    want = (x.float() @ w.float()).to(torch.bfloat16)
    dx = TS.distribute_tree({"x": x}, {"x": TS.P("data", None, "model")},
                            mesh)["x"]
    dw = TS.distribute_tree({"w": w}, {"w": TS.P("model", None)}, mesh)["w"]
    with use_mesh(mesh):
        got = TL.dot(dx, dw).full_tensor()
    plain = torch.matmul(dx, dw).full_tensor()
    np.save(os.path.join(out_dir, f"rowpar-{rank}.npy"), np.array([
        float((got != want).float().mean()),
        float((plain != want).float().mean())]))


@contextlib.contextmanager
def _grads_on_another_thread():
    """``torch.autograd.grad`` run on a new thread, with the caller's
    dispatch modes (the dry-run's ``StepCounter``): as the autograd
    engine runs a CUDA backward on its device thread, which inherits
    those but no Python thread-local state."""
    from torch.utils._python_dispatch import (
        _get_current_dispatch_mode_stack)
    grad = torch.autograd.grad

    def on_thread(*args, **kw):
        modes, out = _get_current_dispatch_mode_stack(), {}

        def run():
            with contextlib.ExitStack() as stack:
                for m in modes:
                    stack.enter_context(m)
                out["grads"] = grad(*args, **kw)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        return out["grads"]
    torch.autograd.grad = on_thread
    try:
        yield
    finally:
        torch.autograd.grad = grad


def _collectives(mesh, rank, out_dir):
    """The collectives of one ZeRO-1 step of reduced bf16 granite-8b in
    "sp" mode under the dry-run's ``StepCounter`` (rank 0's), with the
    backward on this thread and on another one; rank 0 saves both."""
    from repro_torch.launch.dryrun import StepCounter
    cfg = get_reduced("granite-8b").with_(dtype="bfloat16")
    step = make_train_step(cfg, lr=LR)
    spec = TS.batch_pspec(mesh, batch_size=B, extra_dims=1)
    out = {}
    for where in ("this thread", "another thread"):
        params, opt = TS.init_sharded_state(
            cfg, mesh, torch.Generator().manual_seed(0), "cpu")
        batch = TS.distribute_tree(_batch(cfg, 30), {"tokens": spec,
                                                     "labels": spec}, mesh)
        counter = StepCounter()
        with contextlib.ExitStack() as stack:
            if where == "another thread":
                stack.enter_context(_grads_on_another_thread())
            with use_mesh(mesh), use_act_mode("sp"), counter:
                step(params, opt, batch)
        out[where] = dict(bytes=counter.collectives,
                          calls=counter.collective_calls)
    if rank == 0:
        with open(os.path.join(out_dir, "collectives.json"), "w") as f:
            json.dump(out, f)


def _parity(rank, out_dir):
    """``parity``'s per-layer check of reduced bf16 qwen2.5-32b on a
    (1, 4) mesh (8 query and 4 kv heads: one kv head a rank, as the full
    config's 8 over four cards gives two), from the unmeshed stream each
    rank computes itself, with the partial sums in fp32 and in bf16;
    rank 0 saves both runs' gaps."""
    from repro_torch.distributed import parity as PA
    mesh = make_debug_mesh((1, 4), device_type="cpu")
    cfg = get_reduced("qwen2.5-32b").with_(
        dtype="bfloat16", n_layers=4, n_heads=8, n_kv_heads=4, d_model=128)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dparams, _ = TS.init_sharded_state(
        cfg, mesh, torch.Generator().manual_seed(0), "cpu", optimizer=False)
    toks = torch.from_numpy(np.random.default_rng(31).integers(
        0, cfg.vocab, (B, 32)).astype(np.int32))
    xs, head = PA.unmeshed_stream(cfg, params, toks)
    wants = dict(enumerate(xs[1:]), head=head)
    spec = TS.batch_pspec(mesh, batch_size=B, extra_dims=2)

    def place(x):
        return TS.distribute_tree({"x": x}, {"x": spec}, mesh)["x"]
    out = {}
    for sums in ("fp32", "bf16"):
        with contextlib.ExitStack() as stack:
            if sums == "bf16":
                stack.enter_context(PA.bf16_partial_sums())
            out[sums] = {str(l): PA.gap(y, wants[l]) for l, y in
                         PA.meshed_outputs(cfg, dparams, mesh,
                                           lambda l: xs[l], place)}
    if rank == 0:
        with open(os.path.join(out_dir, "parity.json"), "w") as f:
            json.dump(out, f)


def _rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_debug_mesh((2, 2), device_type="cpu")
        _check_init(mesh, rank, out_dir)
        _train(mesh, rank, out_dir)
        _int8(mesh, rank, out_dir)
        _mlp(mesh, rank, out_dir)
        _row_parallel(mesh, rank, out_dir)
        _collectives(mesh, rank, out_dir)
        _parity(rank, out_dir)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    tmp.spawn(_rank, args=(4, _free_port(), str(out)), nprocs=4, join=True)
    return out


@pytest.mark.slow
def test_sharded_state_equals_distributed_init(ranks):
    for rank in range(4):
        bad = np.load(ranks / f"init-{rank}.npy")
        assert bad.size == 0, (rank, list(bad)[:5])


@pytest.mark.slow
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_zero1_steps_match_unmeshed(ranks, arch):
    r = np.load(ranks / f"train-{arch}.npz")
    want, got = r["metrics"]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    n = sum(k.startswith("want") for k in r.files)
    worst = []
    for i in range(n):
        w, g = r[f"want{i}"], r[f"got{i}"]
        assert g.shape == w.shape
        worst.append(np.abs(g - w).max() / np.abs(w).max())
    assert max(worst) <= RTOL, (arch, worst)


@pytest.mark.slow
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_zero1_placements_after_a_step(ranks, arch):
    for rank in range(4):
        rows = json.loads((ranks / f"placements-{arch}-{rank}.json")
                          .read_text())
        assert any(row[4] for row in rows)
        for p, m, v, n, data in rows:
            assert not p[0].startswith("S("), p  # params: not on "data"
            assert m == v == n
            assert m[0].startswith("S(") == data, (m, data)
            assert m[1] == p[1]  # the "model" placement is the param's


@pytest.mark.slow
def test_int8_allreduce_over_the_data_group(ranks):
    for rank in range(4):
        for err, scale, top in np.load(ranks / f"int8-{rank}.npy"):
            assert top > 0 and err <= scale, (rank, err, scale)


@pytest.mark.slow
def test_fused_mlp_gathers_its_weight_not_its_product(ranks):
    for rank in range(4):
        err, gathered, wi_bytes = np.load(ranks / f"mlp-{rank}.npy")
        assert err <= 1e-6, (rank, err)
        assert gathered == wi_bytes, (rank, gathered, wi_bytes)


@pytest.mark.slow
def test_row_parallel_dot_sums_partials_in_fp32(ranks):
    for rank in range(4):
        got, plain = np.load(ranks / f"rowpar-{rank}.npy")
        assert got <= 1e-2, (rank, got)
        assert plain > 10 * max(got, 1e-3), (rank, plain)


@pytest.mark.slow
@pytest.mark.parametrize("where", ["this thread", "another thread"])
def test_zero1_step_collectives_match_the_dryrun(ranks, where):
    """The reduced bf16 granite-8b ZeRO-1 step on (2, 2) in "sp" mode
    counts, under ``StepCounter``, the all-reduce and reduce-scatter
    calls and bytes of ``launch.dryrun.run_cell`` with the same config,
    shape and mesh, also with its backward on another thread (where the
    card runs it: the checkpointed blocks' recompute must keep "sp").
    gloo has no all-to-all and runs one as an all-gather of every rank's
    whole input (then keeps its chunk), so all-gather agrees once each
    of the dry-run's all-to-alls is added as a call with the bytes of
    its result times its 2-rank "model" group."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import ShapeSpec
    full = get_config("granite-8b")
    red = get_reduced("granite-8b").with_(dtype="bfloat16")
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(full, f.name) != getattr(red, f.name)}
    dry = D.run_cell("granite-8b", "tiny", shape=ShapeSpec(
        "tiny", S, B, "train"), mesh_shape=(2, 2), accum_steps=1,
        act_mode="sp", overrides=over, save=False)["collectives"]
    got = json.loads((ranks / "collectives.json").read_text())[where]
    for kind in ("all-reduce", "reduce-scatter"):
        assert got["calls"][kind] == dry["calls"][kind], kind
        assert got["bytes"][kind] == dry[kind], kind
    assert dry["all-to-all"] > 0 and got["bytes"]["all-to-all"] == 0
    assert got["calls"]["all-gather"] == (dry["calls"]["all-gather"]
                                         + dry["calls"]["all-to-all"])
    assert got["bytes"]["all-gather"] == dry["all-gather"] \
        + 2 * dry["all-to-all"]


@pytest.mark.slow
def test_per_layer_parity_passes_fp32_sums_and_catches_bf16_ones(ranks):
    """``parity``'s per-layer check on a (1, 4) gloo mesh: every layer and
    the head within ``LAYER_RTOL`` / ``LAYER_MISMATCH`` of the unmeshed
    ones with ``dot_f32_sum``, and every layer outside them with the
    row-parallel partial products summed in bf16."""
    from repro_torch.distributed import parity as PA
    got = json.loads((ranks / "parity.json").read_text())
    assert set(got["fp32"]) == {"0", "1", "2", "3", "head"}
    assert all(PA.within(g) for g in got["fp32"].values()), got["fp32"]
    layers = [g for k, g in got["bf16"].items() if k != "head"]
    assert not any(PA.within(g) for g in layers), got["bf16"]
