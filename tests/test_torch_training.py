"""PyTorch port: training (``repro_torch.training``, ``launch.train``)
against the reference's ``repro.training``: ``tests/test_training.py``
run on the port and, where the two packages can be held to each other,
across them.  Weights cross through ``convert.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models.model import init_params as j_init  # noqa: E402
from repro.training import adamw as JA  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro.training import compress as JZ  # noqa: E402
from repro.training.data import make_pipeline as j_pipeline  # noqa: E402
from repro.training.step import make_serve_steps as j_serve_steps  # noqa: E402
from repro.training.step import make_train_step as j_train_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402
from repro_torch.training.adamw import (  # noqa: E402
    AdamWState, adamw_init, adamw_update,
)
from repro_torch.training.checkpoint import (  # noqa: E402
    latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.training.compress import (  # noqa: E402
    dequantize_int8, int8_allreduce, make_error_feedback_compressor,
    quantize_int8, simulate_int8,
)
from repro_torch.training.data import (  # noqa: E402
    SyntheticCorpus, make_pipeline,
)
from repro_torch.training.fault import (  # noqa: E402
    RestartableLoop, StepWatchdog,
)
from repro_torch.training.step import (  # noqa: E402
    make_serve_steps, make_train_step,
)
from repro_torch.training.tree import tree_leaves, tree_map  # noqa: E402


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _torch_tree(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _torch_state(jopt):
    return AdamWState(torch.from_numpy(np.array(jopt.step)),
                      *(_torch_tree(t) for t in jopt[1:]))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.fixture(scope="module")
def small():
    """The reference test's fixture, in both packages: reduced
    granite-8b, the reference's weights, batches of 4 x 32."""
    jcfg, cfg = j_reduced("granite-8b"), get_reduced("granite-8b")
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    batch = next(make_pipeline(cfg.vocab, 4, 32, seed=1))
    return jcfg, cfg, jparams, batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ data


def test_batches_match_reference():
    for seed, (V, B, S) in [(0, (256, 2, 16)), (7, (49152, 4, 64))]:
        a, b = make_pipeline(V, B, S, seed=seed), j_pipeline(V, B, S,
                                                             seed=seed)
        for _ in range(3):
            xa, xb = next(a), next(b)
            assert xa.keys() == xb.keys()
            for k in xa:
                np.testing.assert_array_equal(xa[k], xb[k])


def test_data_pipeline_deterministic():
    a = make_pipeline(128, 2, 16, seed=7)
    b = make_pipeline(128, 2, 16, seed=7)
    for _ in range(3):
        xa, xb = next(a), next(b)
        np.testing.assert_array_equal(xa["tokens"], xb["tokens"])
        np.testing.assert_array_equal(xa["labels"], xb["labels"])
        np.testing.assert_array_equal(xa["tokens"][:, 1:],
                                      xa["labels"][:, :-1])
    toks = SyntheticCorpus(128, seed=3).tokens(100)
    assert toks.min() >= 0 and toks.max() < 128


# ----------------------------------------------------------------- adamw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Two AdamW updates on identical numpy grads (one large enough to
    be clipped): parameters, masters, moments and the step count."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 16), "b": {"c": (16,), "d": (3, 4, 5)}}
    as_np = lambda f: jax.tree.map(  # noqa: E731
        f, shapes, is_leaf=lambda s: isinstance(s, tuple))
    params_np = as_np(lambda s: rng.standard_normal(s).astype(np.float32))
    jparams = jax.tree.map(lambda x: jnp.asarray(x, dtype), params_np)
    tparams = _torch_tree(jparams)
    jopt, topt = JA.adamw_init(jparams), adamw_init(tparams)
    for scale in (0.1, 10.0):  # grad norm ~1, then ~100 (clipped)
        grads_np = as_np(lambda s: (scale * rng.standard_normal(s)).astype(
            np.float32))
        jparams, jopt = JA.adamw_update(
            jax.tree.map(lambda x: jnp.asarray(x, dtype), grads_np), jopt,
            jparams, lr=1e-2)
        tparams, topt = adamw_update(
            _torch_tree(jax.tree.map(lambda x: jnp.asarray(x, dtype),
                                     grads_np)), topt, tparams, lr=1e-2)
    assert int(topt.step) == int(jopt.step) == 2
    for want, got in ((jparams, tparams), (jopt.master, topt.master),
                      (jopt.mu, topt.mu), (jopt.nu, topt.nu)):
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert b.dtype == getattr(torch, str(a.dtype))
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_state_is_fp32_and_separate():
    params = {"w": torch.ones(3, dtype=torch.float32),
              "v": torch.ones(2, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert isinstance(opt, AdamWState) and opt.step.dtype == torch.int32
    for tree in (opt.master, opt.mu, opt.nu):
        assert all(t.dtype == torch.float32 for t in tree_leaves(tree))
    # masters are copies even of fp32 parameters (updated in place)
    assert opt.master["w"].data_ptr() != params["w"].data_ptr()


def test_adamw_decreases_loss(small):
    """Eight steps at lr 1e-3 on one batch in each package: the port's
    loss falls; its first step's loss and grad norm equal the
    reference's (2e-4), and its losses stay within 1e-3 of the
    reference's over the eight steps (Adam's update is g / sqrt(v): a
    grad near zero turns a rounding difference into a step of up to lr,
    so the two trajectories part slowly)."""
    jcfg, cfg, jparams, batch = small
    params = _torch_tree(jparams)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=1e-3)
    jstep = jax.jit(j_train_step(jcfg, lr=1e-3))
    jopt = JA.adamw_init(jparams)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, jlosses = [], []
    for i in range(8):
        params, opt, m = step(params, opt, _tb(batch))
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
        if i == 0:
            for k in ("loss", "ce_loss", "grad_norm"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=2e-4)
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)


def _captured_grads(cfg, accum_steps):
    """make_train_step with a compress_fn that records the grads it is
    handed (and passes them on)."""
    seen = []

    def spy(grads):
        seen.append(tree_map(lambda g: g.clone(), grads))
        return grads
    return make_train_step(cfg, lr=1e-3, accum_steps=accum_steps,
                           compress_fn=spy), seen


def test_grad_accumulation_matches_full_batch(small):
    jcfg, cfg, jparams, batch = small
    params = _torch_tree(jparams)
    full, g_full = _captured_grads(cfg, 1)
    acc, g_acc = _captured_grads(cfg, 2)
    p1, _, m1 = full(_clone(params), adamw_init(params), _tb(batch))
    p2, _, m2 = acc(_clone(params), adamw_init(params), _tb(batch))
    for a, b in zip(tree_leaves(g_full[0]), tree_leaves(g_acc[0])):
        assert b.dtype == torch.float32  # accumulated in fp32
        np.testing.assert_allclose(_np(b), _np(a), rtol=2e-4, atol=2e-5)
    # same gradient => same update (the reference test's check)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)
    # the reference's accumulated step lands on the same parameters
    jp2, _, jm2 = jax.jit(j_train_step(jcfg, lr=1e-3, accum_steps=2))(
        jparams, JA.adamw_init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=2e-4)
    for a, b in zip(jax.tree.leaves(jp2), tree_leaves(p2)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=2e-4,
                                   atol=2e-3)


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip_and_atomicity(tmp_path, dtype):
    cfg = get_reduced("granite-8b").with_(dtype=dtype)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params)
    opt.step.fill_(3)
    save_checkpoint(tmp_path, 5, (params, opt), extra={"note": "x"})
    assert latest_step(tmp_path) == 5
    target = tree_map(torch.zeros_like, (params, opt))
    (rp, ro), meta = restore_checkpoint(tmp_path, 5, target)
    assert meta["step"] == 5 and meta["extra"] == {"note": "x"}
    assert isinstance(ro, AdamWState) and int(ro.step) == 3
    for a, b in zip(tree_leaves((params, opt)), tree_leaves((rp, ro))):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a stale .tmp dir must not be visible as a checkpoint
    os.makedirs(tmp_path / "step_00000009.tmp" / "arrays")
    assert latest_step(tmp_path) == 5
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, 5, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, dtype, writer):
    """(params, AdamW state) written by one package restores in the
    other, bit for bit: the leaf order is jax.tree.flatten's, bf16 leaves
    are read as raw 16-bit words (a reference file) or written widened
    to fp32 (a port file)."""
    jcfg = j_reduced("granite-8b").with_(dtype=dtype)
    jparams = j_init(jcfg, jax.random.PRNGKey(2))
    jopt = JA.adamw_init(jparams)
    jopt = jopt._replace(step=jnp.asarray(4, jnp.int32),
                         mu=jax.tree.map(lambda m: m + 0.5, jopt.mu))
    tparams, topt = _torch_tree(jparams), _torch_state(jopt)
    if writer == "reference":
        JC.save_checkpoint(tmp_path, 7, (jparams, jopt))
        target = tree_map(torch.zeros_like, (tparams, topt))
        got, meta = restore_checkpoint(tmp_path, 7, target)
        want = (tparams, topt)
    else:
        save_checkpoint(tmp_path, 7, (tparams, topt))
        got, meta = JC.restore_checkpoint(
            tmp_path, 7, jax.tree.map(jnp.zeros_like, (jparams, jopt)))
        got = (_torch_tree(got[0]), _torch_state(got[1]))
        want = (tparams, topt)
    assert meta["step"] == 7
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl) == len(jax.tree.leaves((jparams, jopt)))
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _reshard_rank(rank, world, port, ckpt_dir, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.distributed import param_shardings
        from repro_torch.launch.mesh import make_debug_mesh
        cfg = get_reduced("granite-8b")
        mesh = make_debug_mesh((1, world), device_type="cpu")
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        target = tree_map(torch.zeros_like, params)
        got, _ = restore_checkpoint(ckpt_dir, 1, target,
                                    shardings=param_shardings(cfg, mesh),
                                    mesh=mesh)
        sharded = [any(p.is_shard() for p in t.placements)
                   for t in tree_leaves(got)]
        same = all(torch.equal(a, b.full_tensor()) for a, b in zip(
            tree_leaves(params), tree_leaves(got)))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"same": same, "sharded": sharded}, f)
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_checkpoint_elastic_reshard(tmp_path):
    """Save unsharded, restore under the parameter placements on a
    2-rank gloo mesh (``("data", "model")`` = (1, 2)): every leaf is a
    DTensor whose whole equals the saved array exactly, and the model
    axis shards some of them."""
    cfg = get_reduced("granite-8b")
    save_checkpoint(tmp_path / "ckpt", 1, M.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    world = 2
    tmp.spawn(_reshard_rank, args=(world, _free_port(),
                                   str(tmp_path / "ckpt"), str(tmp_path)),
              nprocs=world, join=True)
    for r in range(world):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["same"]
        assert any(got["sharded"]) and not all(got["sharded"])


# ------------------------------------------------------------ compression


def test_int8_compression_error_bounded():
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=(64, 64)).astype(np.float32)
    g = torch.from_numpy(g_np)
    q, scale = quantize_int8(g)
    jq, jscale = JZ.quantize_int8(jnp.asarray(g_np))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    back = dequantize_int8(q, scale).numpy()
    assert np.abs(back - g_np).max() <= float(scale) * 0.5 + 1e-6
    ghat = simulate_int8({"g": g})["g"]
    assert np.abs(ghat.numpy() - g_np).max() <= float(scale) * 0.5 + 1e-6


def test_error_feedback_reduces_bias():
    """With error feedback the average of compressed grads converges to
    the true gradient (residual accumulation), as the reference's."""
    rng = np.random.default_rng(1)
    g_np = (rng.normal(size=(32,)) * 1e-3).astype(np.float32)
    g = torch.from_numpy(g_np)
    compress, jcompress = (make_error_feedback_compressor(),
                           JZ.make_error_feedback_compressor())
    state, jstate = None, None
    acc = np.zeros(32, np.float32)
    n = 64
    for i in range(n):
        ghat, state = compress({"g": g}, state)
        acc += ghat["g"].numpy()
        if i < 3:  # the same codes as the reference's compressor
            jhat, jstate = jcompress({"g": jnp.asarray(g_np)}, jstate)
            np.testing.assert_allclose(ghat["g"].numpy(),
                                       np.asarray(jhat["g"]), rtol=1e-6,
                                       atol=1e-9)
    mean_err = np.abs(acc / n - g_np).max()
    one_shot = np.abs(simulate_int8({"g": g})["g"].numpy() - g_np).max()
    assert mean_err <= one_shot + 1e-7


def test_compression_in_train_step_still_converges(small):
    _, cfg, jparams, batch = small
    params = _torch_tree(jparams)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=1e-3, compress_fn=simulate_int8)
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, _tb(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _allreduce_rank(rank, world, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        rng = np.random.default_rng(10 + rank)
        grads = {"a": torch.from_numpy(rng.normal(size=(33, 7)).astype(
                     np.float32) * (rank + 1)),
                 "b": {"c": torch.from_numpy(rng.normal(size=(5,)).astype(
                     np.float32)).to(torch.bfloat16)}}
        out = int8_allreduce(grads)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 a=out["a"].numpy(), c=out["b"]["c"].float().numpy(),
                 c_dtype=str(out["b"]["c"].dtype))
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_int8_allreduce_two_process_gloo(tmp_path):
    """A 2-process gloo group: every rank gets the mean through the
    shared-max-scale int8 code sum."""
    world = 2
    tmp.spawn(_allreduce_rank, args=(world, _free_port(), str(tmp_path)),
              nprocs=world, join=True)
    grads = []
    for r in range(world):
        rng = np.random.default_rng(10 + r)
        a = rng.normal(size=(33, 7)).astype(np.float32) * (r + 1)
        c = torch.from_numpy(rng.normal(size=(5,)).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
        grads.append((a, c))

    def shared_sum(xs):
        scale = max(np.float32(np.abs(x).max()) / np.float32(127.0)
                    for x in xs)
        codes = sum(np.clip(np.round(x / scale), -127, 127) for x in xs)
        return codes.astype(np.float32) * scale / np.float32(world)
    want_a = shared_sum([g[0] for g in grads])
    want_c = torch.from_numpy(shared_sum([g[1] for g in grads])).to(
        torch.bfloat16).float().numpy()
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["a"], want_a, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got["c"], want_c)
        assert str(got["c_dtype"]) == "torch.bfloat16"
        # the mean, up to one quantization step of the shared scale
        mean = (grads[0][0] + grads[1][0]) / 2
        scale = max(np.abs(g[0]).max() for g in grads) / 127.0
        assert np.abs(got["a"] - mean).max() <= scale + 1e-6


# ---------------------------------------------------------------- faults


def test_restartable_loop_recovers_from_failure(tmp_path):
    """Inject a failure mid-run; the loop restarts from the latest
    checkpoint and completes with identical final state."""
    calls = {"n": 0}

    def step_fn(step, state):
        calls["n"] += 1
        if calls["n"] == 7:  # one-time fault
            raise RuntimeError("injected node failure")
        return state + 1

    def save(step, state):
        (tmp_path / f"s{step}.json").write_text(json.dumps(
            {"step": step, "state": int(state)}))

    def latest():
        steps = sorted(int(p.stem[1:]) for p in tmp_path.glob("s*.json"))
        return steps[-1] if steps else None

    def restore(step):
        d = json.loads((tmp_path / f"s{step}.json").read_text())
        return d["step"], d["state"]

    loop = RestartableLoop(step_fn=step_fn, make_state=lambda: 0,
                           save=save, restore=restore, latest=latest,
                           ckpt_every=2, max_restarts=2)
    step, state, stats = loop.run(10)
    assert step == 10 and state == 10
    assert stats.restarts == 1


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(soft_deadline_s=0.01, hard_deadline_s=10.0)
    wd.run(lambda: time.sleep(0.02))
    wd.run(lambda: None)
    assert wd.stats.slow_steps == 1
    assert wd.stats.steps == 2


# ------------------------------------------------------- serve steps, CLI


def test_serve_steps_match_reference(small):
    jcfg, cfg, jparams, _ = small
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    jpre, jdec = j_serve_steps(jcfg, cache_len=12)
    pre, dec = make_serve_steps(cfg, cache_len=12)
    params = _torch_tree(jparams)
    jt, jc = jpre(jparams, {"tokens": jnp.asarray(toks)})
    t, c = pre(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    jtok, ttok = jt[:, None], t[:, None]
    for i in range(3):
        pos = np.full((2,), 8 + i, np.int32)
        jtok, jlog, jc = jdec(jparams, jtok, jnp.asarray(pos), jc)
        ttok, tlog, c = dec(params, ttok, torch.from_numpy(pos), c)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.slow
def test_train_launcher_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch
    args = ["--arch", "granite-8b", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    launch.main(args + ["--steps", "3"])
    assert latest_step(tmp_path) == 3
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary.keys() == {"first10_loss", "last10_loss", "straggler"}
    assert summary["straggler"]["steps"] == 3
    launch.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert json.loads(out.strip().splitlines()[-1])["straggler"][
        "steps"] == 2
    assert latest_step(tmp_path) == 5


@pytest.mark.slow
def test_train_100m_example_reduces_loss(capsys):
    from repro_torch.examples import train_100m
    summary = train_100m.main(["--steps", "20", "--batch", "4", "--seq",
                               "64", "--device", "cpu"])
    assert len(summary["losses"]) == 20
    assert capsys.readouterr().out.strip().endswith("OK")
