"""PyTorch port: the distribution layer (``repro_torch.distributed``,
``models.partition``, ``models.inputs``, ``launch.mesh``,
``launch.dryrun``) against the reference's.

``tests/test_distribution.py`` is ported but for its HLO parser
(``collective_bytes``): the port's dry-run runs every loop as Python
and counts each collective as it is issued, so its counts are
loop-aware by construction, and the Python loops over time that it runs
loop-aware are held to the full loop below.  The reference's spec
functions take a duck mesh (an object with a ``shape`` dict), so the
specs are compared on the production meshes without devices.  Fake
process groups live inside ``dryrun.fake_world`` (torn down on exit);
the real sharded run spawns four gloo processes.
"""

import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import socket  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from benchmarks.costmodel import (  # noqa: E402
    _attn_flops, _kv_len_for, forward_flops,
)
from repro import configs as jcfgs  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import partition as JPART  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import SHAPES, applicable_shapes  # noqa: E402
from repro_torch.models import input_specs, materialize  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import partition as TPART  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402
from repro_torch.models.partition import P  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}


def duck(sizes):
    return types.SimpleNamespace(shape=dict(sizes))


def _paths(tree, prefix=()):
    """{path: leaf} of a nested dict (a P or a tuple is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _j_paths(tree):
    """{path: P entries} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in path):
            tuple(p) for path, p in flat}


# ------------------------------------------------- tests/test_distribution


def test_resolve_axes_divisibility_fallback():
    spec = TS.resolve_axes((49155, 1024), ("vocab", "embed"),
                           TS.DEFAULT_RULES, duck({"model": 1}))
    assert spec == P()  # model axis size 1 -> nothing to shard
    # 49155 does not divide 16: replicated; 1024 "embed": never sharded
    assert TS.resolve_axes((49155, 1024), ("vocab", "embed"),
                           TS.DEFAULT_RULES, duck({"model": 16})) == P()
    assert TS.resolve_axes((49152, 1024), ("vocab", "embed"),
                           TS.DEFAULT_RULES,
                           duck({"model": 16})) == P("model")


@pytest.mark.parametrize("arch", ["gemma3-27b", "whisper-large-v3",
                                  "olmoe-1b-7b"])
def test_param_pspecs_structure_matches_params(arch):
    cfg = get_config(arch)
    specs = _paths(TS.param_pspecs(cfg, duck({"data": 1, "model": 1})))
    tmpl = _paths(TM.model_template(cfg))
    assert specs.keys() == tmpl.keys()
    assert all(isinstance(s, P) for s in specs.values())


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "recurrentgemma-2b",
                                  "xlstm-350m", "whisper-large-v3"])
def test_cache_pspecs_structure_matches_cache(arch):
    cfg = get_config(arch)
    specs = _paths(TS.cache_pspecs(cfg, duck({"data": 1, "model": 1}), 4,
                                   64))
    leaves = dict(TM._leaves(TM.init_cache(cfg, 4, 64, "meta")))
    assert {"/".join(k) for k in specs} == leaves.keys()
    for k, s in specs.items():  # every spec has rank <= leaf rank
        assert len(s) <= leaves["/".join(k)].ndim


def test_opt_pspecs_zero1_adds_data_axis():
    cfg = get_config("granite-8b")
    mesh = duck({"data": 32, "model": 8})
    o = TS.opt_pspecs(cfg, mesh)
    p = _paths(TS.param_pspecs(cfg, mesh))
    assert _paths(o.master).keys() == p.keys() and o.step == P()
    for k, spec in _paths(o.master).items():
        assert "data" in spec, k  # every granite leaf has a dim % 32 == 0
        assert [a for a in spec if a not in (None, "data")] == \
            [a for a in p[k] if a is not None]


def test_input_specs_all_cells_build():
    """Every (arch x applicable shape) cell has meta-tensor inputs: 32
    cells, no storage."""
    n = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in applicable_shapes(cfg):
            spec = input_specs(cfg, SHAPES[shape_name])
            leaves = [t for _, t in TM._leaves(spec)]
            assert leaves and all(t.device.type == "meta" for t in leaves)
            if SHAPES[shape_name].kind == "decode":
                assert "caches" in spec and "pos" in spec
                assert spec["pos"].dtype == torch.int32
            n += 1
    assert n == 32  # 3 shapes x 10 archs + long_500k x 2 subquadratic


def test_long500k_applicability():
    subq = [a for a in ARCH_IDS
            if "long_500k" in applicable_shapes(get_config(a))]
    assert sorted(subq) == ["recurrentgemma-2b", "xlstm-350m"]


def test_input_specs_match_reference_shapes():
    """Each cell's inputs have the reference's shapes and dtypes (the
    decode caches leaf by leaf)."""
    from repro.models import input_specs as j_input_specs
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jcfgs.get_config(arch)
        for shape_name in applicable_shapes(cfg):
            got = _paths(input_specs(cfg, SHAPES[shape_name]))
            want = {k: v for k, v in _j_paths_sds(j_input_specs(
                jcfg, SHAPES[shape_name])).items()}
            assert got.keys() == want.keys(), (arch, shape_name)
            for k, t in got.items():
                assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == \
                    want[k], (arch, shape_name, k)


def _j_paths_sds(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", k) for k in path):
            (tuple(s.shape), str(s.dtype)) for path, s in flat}


def test_materialize_is_deterministic_and_in_range():
    cfg = get_reduced("granite-8b")
    spec = input_specs(cfg, ShapeSpec("tiny", 16, 2, "decode"))
    a, b = materialize(spec, seed=3), materialize(spec, seed=3)
    c = materialize(spec, seed=4)
    la, lb = dict(TM._leaves(a)), dict(TM._leaves(b))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(a["token"], c["token"]) or \
        not torch.equal(a["pos"], c["pos"])
    for k, t in la.items():
        assert t.device.type == "cpu"
        if not t.dtype.is_floating_point:
            assert 0 <= int(t.min()) and int(t.max()) < 64, k


# ------------------------------------------- specs against the reference


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_specs_match_reference(arch, mesh_name):
    """param, ZeRO-1 optimizer, batch and cache specs: the reference's,
    leaf by leaf by path, at full width on the production meshes."""
    sizes = MESHES[mesh_name]
    cfg, jcfg = get_config(arch), jcfgs.get_config(arch)
    mesh = duck(sizes)
    assert {k: tuple(v) for k, v in _paths(
        TS.param_pspecs(cfg, mesh)).items()} == \
        _j_paths(JS.param_pspecs(jcfg, mesh))
    o, jo = TS.opt_pspecs(cfg, mesh), JS.opt_pspecs(jcfg, mesh)
    assert tuple(o.step) == tuple(jo.step)
    for part in ("master", "mu", "nu"):
        assert {k: tuple(v) for k, v in _paths(
            getattr(o, part)).items()} == _j_paths(getattr(jo, part))
    for B in (1, 4, 32, 128, 256):
        for extra in (0, 1, 2):
            assert tuple(TS.batch_pspec(mesh, batch_size=B,
                                        extra_dims=extra)) == tuple(
                JS.batch_pspec(mesh, batch_size=B, extra_dims=extra))
    assert tuple(TS.batch_pspec(mesh)) == tuple(JS.batch_pspec(mesh))
    for B, L in ((128, 32768), (1, 524288)):
        assert {k: tuple(v) for k, v in _paths(
            TS.cache_pspecs(cfg, mesh, B, L)).items()} == \
            _j_paths(JS.cache_pspecs(jcfg, mesh, B, L))


def test_logical_axes_match_reference():
    for arch in ARCH_IDS:
        got = {k: tuple(v) for k, v in _paths(
            TM.logical_axes(get_config(arch))).items()}
        flat = jax.tree_util.tree_flatten_with_path(
            JM.logical_axes(jcfgs.get_config(arch)),
            is_leaf=lambda x: isinstance(x, tuple))[0]
        want = {tuple(k.key for k in path): v for path, v in flat}
        assert got == want, arch


# --------------------------------------- activation specs at every site

ACT_MESH = {"pod": 2, "data": 2, "model": 2}


def _record_reference(monkeypatch, jcfg, params, tokens, extras, mode):
    """(names, shape, spec) of each reference ``constrain`` call in one
    forward under a duck mesh."""
    calls = []
    monkeypatch.setattr(JPART, "_current_mesh", lambda: duck(ACT_MESH))

    def wsc(x, spec):
        calls[-1] = calls[-1] + (tuple(spec),)
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", wsc)
    orig = JPART.constrain

    def rec(x, *names):
        calls.append((tuple(names), tuple(x.shape)))
        return orig(x, *names)
    for mod in (JL, JM):
        monkeypatch.setattr(mod, "constrain", rec)
    with JPART.use_act_mode(mode):
        JM.forward(jcfg, params, tokens, **extras)
    return calls


def _record_port(monkeypatch, cfg, params, tokens, extras, mode):
    calls = []

    def rec(x, *names):
        calls.append((tuple(names), tuple(x.shape), tuple(TPART.act_spec(
            x.shape, names, ACT_MESH, TPART.act_mode()))))
        return x
    for mod in (TL, TM):
        monkeypatch.setattr(mod, "constrain", rec)
    with TPART.use_act_mode(mode):
        TM.forward(cfg, params, tokens, **extras)
    return calls


# the reference's sites the port has no counterpart of: the one-hot
# dispatch and combine tensors of its MoE (the port routes by index and
# constrains the dispatched rows alone), and the k and v its cross
# attention projects from the decoder's input and never reads
_REF_ONLY = {("batch", None, "experts", None), ("batch", None, "kv_heads")}
# an encoder block's sites: its carry, q, k, v and the MLP's two
_ENCODER_SITES = 6


@pytest.mark.parametrize("mode", ["dp", "sp"])
@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_activation_specs_match_reference(monkeypatch, arch, mode):
    # unrolled, so the reference traces each layer's sites (its scanned
    # layers trace one body per group); the same parameters
    jcfg = jcfgs.get_reduced(arch).with_(dtype="float32",
                                         scan_layers=False)
    cfg = get_reduced(arch).with_(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    B, S = 4, 16
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extras = {}
    if cfg.vision_tokens:
        extras["patch_embeds"] = rng.normal(
            size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        extras["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = _record_reference(monkeypatch, jcfg, jparams, jnp.asarray(tok),
                             {k: jnp.asarray(v) for k, v in extras.items()},
                             mode)
    got = _record_port(monkeypatch, cfg, params, torch.from_numpy(tok),
                       {k: torch.from_numpy(v) for k, v in extras.items()},
                       mode)
    assert got, arch
    if cfg.encoder_layers:  # the reference scans its encoder: one body
        block = got[:_ENCODER_SITES]
        n = cfg.encoder_layers * _ENCODER_SITES
        assert got[:n] == block * cfg.encoder_layers
        got = block + got[n:]
    # the port's sites, in order, are the reference's but for _REF_ONLY
    left, i = [], 0
    for w in want:
        if i < len(got) and got[i] == w:
            i += 1
        else:
            left.append(w)
    assert i == len(got), (arch, got[i], want)
    n_moe = cfg.n_layers if cfg.moe else 0
    n_cross = 2 * cfg.n_layers if cfg.encoder_layers else 0
    assert len(left) == 2 * n_moe + n_cross, left
    assert all(w[0] in _REF_ONLY for w in left), left


@pytest.mark.parametrize("shape,names", [
    ((8, 64, 32), ("batch", "seq", "embed")),
    ((3, 64, 32), ("batch", "seq", "embed")),
    ((8, 7, 48), ("batch", None, "heads")),
    ((4, 8, 6, 2), ("experts", "batch", None, "embed")),
    ((16, 24), ("tokens", "ff")),
    ((2, 4, 10), ("batch", "seq", "vocab")),
])
@pytest.mark.parametrize("mesh_name", list(MESHES) + ["act"])
@pytest.mark.parametrize("mode", ["dp", "sp"])
def test_act_spec_matches_reference_constrain(monkeypatch, shape, names,
                                              mesh_name, mode):
    sizes = ACT_MESH if mesh_name == "act" else MESHES[mesh_name]
    got = []
    monkeypatch.setattr(JPART, "_current_mesh", lambda: duck(sizes))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: got.append(tuple(spec)) or x)
    with JPART.use_act_mode(mode):
        JPART.constrain(jnp.zeros(shape), *names)
    assert tuple(TPART.act_spec(shape, names, sizes, mode)) == got[0]


# ------------------------------------------------------- the dry-run


def _reduced_overrides(arch):
    """The fields of ``get_reduced(arch)`` that differ from the full
    config, as ``run_cell`` overrides."""
    import dataclasses
    full, red = get_config(arch), get_reduced(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(full, f.name) != getattr(red, f.name)}


def test_dryrun_forward_flops_match_costmodel():
    """The dry-run's FLOPs of a reduced dense prefill on one device (per
    device is all) against the reference's structural model
    (``benchmarks.costmodel.forward_flops``), exactly, once its causal
    attention term is counted over all S keys (as the plain attention
    computes it) and pixtral's ``vision_proj`` is added (the model leaves
    it out).  MoE archs are left out: the port routes without the
    reference's one-hot dispatch, which the model counts."""
    shape = ShapeSpec("tiny", 64, 4, "prefill")
    for arch in ("granite-8b", "qwen2.5-32b", "gemma2-9b", "gemma3-27b",
                 "pixtral-12b"):
        r = D.run_cell(arch, "tiny", shape=shape, mesh_shape=(1, 1),
                       overrides=_reduced_overrides(arch), save=False)
        jcfg = jcfgs.get_reduced(arch)
        want = forward_flops(jcfg, shape)
        pat = JM.block_pattern_of(jcfg)
        for li in range(jcfg.n_layers):  # the causal half, computed too
            kind = pat[li % len(pat)]
            want += _attn_flops(jcfg, shape.global_batch * shape.seq_len,
                                shape.seq_len - _kv_len_for(jcfg, kind,
                                                            shape))
        if jcfg.vision_tokens:  # vision_proj, which the model leaves out
            want += 2 * shape.global_batch * jcfg.vision_tokens * \
                jcfg.d_model ** 2
        assert r["cost"]["flops"] == want, arch


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-2b"])
def test_loop_aware_counts_match_the_full_loop(arch, kind):
    """At S 8 on a (2, 2) mesh, the dry-run's loop-aware Python loops
    over time (the mLSTM / sLSTM scans, the plain RG-LRU scan) count the
    full loop's FLOPs and collectives exactly, forward and backward, and
    a forward's bytes exactly.  A train step's bytes leave out what the
    autograd engine does between nodes for the repeated steps (summing
    the per-step gradients of each sliced input), so they read at most
    the full loop's and within 10% of it here."""
    shape = ShapeSpec("tiny", 8, 4, kind)
    kw = dict(shape=shape, mesh_shape=(2, 2), accum_steps=1, save=False,
              overrides=_reduced_overrides(arch))
    aware = D.run_cell(arch, "tiny", loop_aware=True, **kw)
    full = D.run_cell(arch, "tiny", loop_aware=False, **kw)
    assert aware["cost"]["flops"] == full["cost"]["flops"] > 0
    assert aware["collectives"] == full["collectives"]
    assert aware["cost"]["ops"] < full["cost"]["ops"]
    got, want = aware["cost"]["bytes_accessed"], \
        full["cost"]["bytes_accessed"]
    if kind == "prefill":
        assert got == want
    else:
        assert 0.9 * want <= got <= want


def test_dryrun_cell_keys_and_sharded_counts():
    """A reduced granite decode cell on a (2, 2) mesh: the reference's
    JSON keys; per-device argument bytes of the params and caches'
    local shards; collectives counted; the fake process group gone."""
    r = D.run_cell("granite-8b", "tiny", mesh_shape=(2, 2), save=False,
                   shape=ShapeSpec("tiny", 32, 4, "decode"),
                   overrides=_reduced_overrides("granite-8b"))
    for k in ("arch", "shape", "mesh", "mesh_axes", "n_devices", "multi_pod",
              "act_mode", "accum_steps", "param_count", "memory", "cost",
              "collectives"):
        assert k in r, k
    assert r["mesh"] == [2, 2] and r["mesh_axes"] == ["data", "model"]
    assert r["n_devices"] == 4 and r["act_mode"] == "dp"
    cfg = get_reduced("granite-8b")
    params = TM.init_params(cfg, None, "meta")
    whole = sum(t.numel() * t.element_size() for _, t in TM._leaves(params))
    cache = sum(t.numel() * t.element_size() for _, t in TM._leaves(
        TM.init_cache(cfg, 4, 32, "meta")))
    arg = r["memory"]["argument_bytes"]
    assert (whole + cache) / 4 < arg < whole + cache
    assert r["collectives"]["total"] > 0 and r["cost"]["flops"] > 0
    assert not dist.is_initialized()


def test_dryrun_temp_leaves_out_arguments_updated_in_place():
    """``temp_bytes`` counts what a step allocates: an in-place update of
    one of its arguments (AdamW's masters and moments; ``run_cell``
    ignores the step's arguments) allocates nothing, a new tensor does."""
    x = torch.zeros(1000, device="meta")
    counter = D.StepCounter()
    counter.ignore([x])
    with counter:
        x.mul_(2.0).add_(1.0)
    assert counter.peak == 0
    with counter:
        y = x * 2.0
    assert counter.peak == 4000 and y.shape == x.shape


def test_production_mesh_on_a_fake_world():
    with D.fake_world(256):
        mesh = TMESH.make_production_mesh()
        assert tuple(mesh.shape) == (32, 8)
        assert mesh.mesh_dim_names == ("data", "model")
    with D.fake_world(512):
        mesh = TMESH.make_production_mesh(multi_pod=True)
        assert tuple(mesh.shape) == (2, 32, 8)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()
    assert TMESH.HW["hbm_bytes"] == 80e9 and \
        TMESH.HW["peak_flops_bf16"] == 989e12


# ------------------------------------- a real sharded run: 4 gloo ranks

GLOO_ARCHS = ("granite-8b", "granite-moe-1b-a400m", "recurrentgemma-2b",
              "whisper-large-v3")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve_path(cfg, params, tok, extras, cache_len, n_dec, place):
    """Prefill and ``n_dec`` greedy decode steps; ``place(t, n_extra)``
    puts an input where the run needs it.  Returns each step's logits as
    whole numpy arrays."""
    out = []
    lg, caches, _ = TM.prefill(cfg, params, place(tok, 1),
                               cache_len=cache_len,
                               **{k: place(v, 2) for k, v in extras.items()})
    for i in range(n_dec + 1):
        whole = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
        out.append(whole.numpy())
        if i == n_dec:
            break
        nxt = whole.argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((tok.shape[0],), tok.shape[1] + i,
                         dtype=torch.int32)
        lg, caches = TM.decode_step(cfg, params, place(nxt, 1),
                                    place(pos, 0), caches)
    return out


def _gloo_rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = TMESH.make_debug_mesh((2, 2), device_type="cpu")
        for arch in GLOO_ARCHS:
            cfg = get_reduced(arch).with_(dtype="float32")
            params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
            rng = np.random.default_rng(1)
            B, S = 4, 16
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
                np.int32))
            extras = {}
            if cfg.encoder_layers:
                extras["enc_frames"] = torch.from_numpy(rng.normal(
                    size=(B, cfg.encoder_seq, cfg.d_model)).astype(
                        np.float32))
            with torch.no_grad():
                want = _serve_path(cfg, params, tok, extras, S + 4, 2,
                                   lambda t, n: t)
                dparams = TS.distribute_params(params, cfg, mesh)

                def place(t, n):
                    spec = TS.batch_pspec(mesh, batch_size=B, extra_dims=n)
                    return TS.distribute_tree({"t": t}, {"t": spec},
                                              mesh)["t"]
                with TPART.use_mesh(mesh):
                    got = _serve_path(cfg, dparams, tok, extras, S + 4, 2,
                                      place)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{arch}.npz"),
                         want=np.stack(want), got=np.stack(got))
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_sharded_serving_on_four_gloo_ranks(tmp_path):
    """Reduced granite-8b, granite-moe-1b-a400m, recurrentgemma-2b (its
    kv heads do not divide the model axis: query heads sharded, caches on
    their slot axis) and whisper-large-v3 on a (2, 2) mesh of four gloo
    processes, parameters and caches placed by the rules: a prefill and
    two decode steps give the unmeshed port's logits within 2e-3 of
    their scale and the same greedy tokens."""
    tmp.spawn(_gloo_rank, args=(4, _free_port(), str(tmp_path)), nprocs=4,
              join=True)
    for arch in GLOO_ARCHS:
        r = np.load(tmp_path / f"{arch}.npz")
        want, got = r["want"], r["got"]
        assert got.shape == want.shape == (3, 4, get_reduced(arch).vocab)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 2e-3, (arch, err)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


GRAD_ARCHS = ("granite-8b", "recurrentgemma-2b", "xlstm-350m")


def _grad_rank(rank, world, port, out_dir):
    from repro_torch.training.tree import tree_leaves, tree_unflatten
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = TMESH.make_debug_mesh((2, 2), device_type="cpu")
        for arch in GRAD_ARCHS:
            cfg = get_reduced(arch).with_(dtype="float32")
            params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
            rng = np.random.default_rng(2)
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(
                np.int32))
            batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}

            def grads(p, b):
                leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
                loss, _ = TM.loss_fn(cfg, tree_unflatten(p, leaves), b)
                return [loss] + list(torch.autograd.grad(loss, leaves))
            want = grads(params, batch)
            dparams = TS.distribute_params(params, cfg, mesh)
            place = {k: TS.distribute_tree({"t": v}, {"t": TS.batch_pspec(
                mesh, batch_size=4, extra_dims=1)}, mesh)["t"]
                for k, v in batch.items()}
            with TPART.use_mesh(mesh), TPART.use_act_mode("sp"):
                got = [g.full_tensor() for g in grads(dparams, place)]
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{arch}.npz"),
                         *[g.detach().numpy() for g in got],
                         *[w.detach().numpy() for w in want])
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_sharded_gradients_on_four_gloo_ranks(tmp_path):
    """Sequence-parallel ("sp") loss and gradients on a (2, 2) gloo mesh
    equal the unmeshed port's: reduced granite-8b (kv heads split),
    recurrentgemma-2b (one kv head: query heads split, k and v
    replicated, their gradients partial sums) and xlstm-350m (its
    scans), the loss and every gradient leaf within 1e-5 of its scale
    (plus 1e-7)."""
    tmp.spawn(_grad_rank, args=(4, _free_port(), str(tmp_path)), nprocs=4,
              join=True)
    for arch in GRAD_ARCHS:
        r = np.load(tmp_path / f"{arch}.npz")
        arrs = [r[f"arr_{i}"] for i in range(len(r.files))]
        got, want = arrs[:len(arrs) // 2], arrs[len(arrs) // 2:]
        assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), arch
        for g, w in zip(got[1:], want[1:]):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-7, \
                arch


def _recompute_probe():
    """A checkpointed function that records the mesh and act mode it sees
    each time it runs (the forward, then the backward's recompute)."""
    seen = []

    def fn(x):
        seen.append((TPART.current_mesh(), TPART.act_mode()))
        return x.sin()
    return TM._checkpointed(fn), seen


@pytest.mark.parametrize("where", ["after the context", "another thread"])
def test_checkpoint_recompute_keeps_mesh_and_act_mode(where):
    """A checkpointed block's recompute runs under the forward's mesh and
    act mode wherever the backward runs: after the ``use_mesh`` context
    has closed, or on another thread, as the autograd engine runs a CUDA
    backward on its device thread.  Without this the card's "sp" step
    recomputed each block in "dp" mode with no mesh and all-reduced a
    row-parallel partial sum that "sp" reduce-scatters."""
    import threading
    fn, seen = _recompute_probe()
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    x = torch.ones(3, requires_grad=True)
    with TPART.use_mesh(mesh), TPART.use_act_mode("sp"):
        y = fn(x).sum()
        if where == "another thread":
            t = threading.Thread(target=y.backward)
            t.start()
            t.join()
    if where == "after the context":
        y.backward()
    assert seen == [(mesh, "sp")] * 2
    assert TPART.current_mesh() is None and TPART.act_mode() == "dp"
    torch.testing.assert_close(x.grad, torch.ones(3).cos())
