"""PyTorch port: ServingEngine against ``repro.serving.ServingEngine``
on reduced configs (dense granite-8b, hybrid recurrentgemma-2b, MoE
granite-moe-1b-a400m, whisper-large-v3, pixtral-12b, gemma2-9b (also
with the int8 KV cache), gemma3-27b and xlstm-350m), on the CPU
(device="cpu").  whisper's ``transcribe`` and pixtral's
``vision_generate`` get random extras, drawn with numpy from a seed.

A deliberate difference: the reference's compiled executables are
re-entrant, while a CUDA engine's decode graphs replay into static
buffers, so the port's engine serves one request at a time (a lock in
``serve``); concurrent serves queue and give the tokens sequential ones
give (``test_concurrent_serves_equal_sequential``; on the card,
``tests/test_torch_cuda.py``).

A reference quirk the port keeps, for parity: a request's prefill runs
before the experts it routed to are materialized, so under a lazy
``experts`` policy the first request that routes to a cold expert is
served (its prefill, and its first token) with that expert's zero
weights; its decode steps then see the drawn weights.
``test_moe_generate_gives_reference_tokens[lazy]`` holds the two engines
to the same tokens through it.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.serving import LoadPolicy as JPolicy  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_reduced as t_reduced  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402
from repro_torch.serving import ServingEngine, LoadPolicy  # noqa: E402


def test_eager_cold_start_builds_everything():
    cfg = t_reduced("qwen2.5-32b")
    eng = ServingEngine(cfg, batch_size=1, prefill_len=8, max_len=24,
                        device="cpu")
    dt = eng.cold_start()
    assert dt > 0
    rep = eng.report()
    assert rep["total_init_s"] > 0
    for row in rep["components"]:
        if row["group"] == "compile":
            assert row["ready"], row


def test_lazy_compile_materializes_on_first_use():
    cfg = t_reduced("granite-8b")
    eng = ServingEngine(cfg, policy=LoadPolicy(
        lazy_groups=frozenset({"compile"})), batch_size=1, prefill_len=8,
        max_len=16, device="cpu")
    eng.cold_start()
    assert not eng.registry["compile.generate"].ready
    out, _ = eng.serve("generate", np.zeros((1, 8), np.int32),
                       max_new_tokens=3)
    assert out.shape == (1, 3)
    assert eng.registry["compile.generate"].ready
    assert not eng.registry["compile.score"].ready


def _engine_pair(arch, **cfg_kw):
    """The reference engine and the port's on the reduced ``arch`` (with
    ``cfg_kw`` changes), on the reference's weights (carried over by
    swapping the port's weights.core builder)."""
    jcfg = j_reduced(arch).with_(**cfg_kw)
    tcfg = t_reduced(arch).with_(**cfg_kw)
    kw = dict(batch_size=2, prefill_len=8, max_len=24)
    jeng = JEngine(jcfg, **kw)
    jeng.cold_start()
    np_params = jax.tree.map(np.asarray, jeng._params)
    teng = ServingEngine(tcfg, device="cpu", **kw)
    teng.registry["weights.core"].build = \
        lambda: from_numpy_tree(np_params, "cpu")
    teng.cold_start()
    return jeng, teng


@pytest.fixture(scope="module", params=["granite-8b", "recurrentgemma-2b",
                                        "whisper-large-v3", "pixtral-12b",
                                        "gemma2-9b", "gemma3-27b",
                                        "xlstm-350m"])
def engines(request):
    return _engine_pair(request.param)


def test_generate_gives_reference_tokens(engines):
    jeng, teng = engines
    toks = np.random.default_rng(0).integers(0, jeng.cfg.vocab, (2, 8))
    want, _ = jeng.serve("generate", toks, max_new_tokens=6)
    got, lat = teng.serve("generate", toks, max_new_tokens=6)
    assert lat > 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_every_entry_gives_reference_tokens(engines):
    """Every generating entry, in the reference's order, with random
    extras (whisper's frames, pixtral's patch embeddings), and each
    extra left out (zeros), against the reference engine's tokens."""
    jeng, teng = engines
    assert teng.entries() == jeng.entries()
    rng = np.random.default_rng(3)
    for entry in teng.entries():
        if entry == "score":
            continue
        shapes = teng._entry_shapes(entry)
        given = {k: rng.standard_normal(shape).astype(np.float32)
                 for k, (shape, _) in shapes.items()}
        for extras in ([given, None] if given else [None]):
            toks = rng.integers(0, jeng.cfg.vocab, (2, 8))
            want, _ = jeng.serve(entry, toks, max_new_tokens=5,
                                 extras=extras)
            got, _ = teng.serve(entry, toks, max_new_tokens=5,
                                extras=extras)
            np.testing.assert_array_equal(
                got, np.asarray(want),
                err_msg=f"{entry} with {sorted(extras or {})}")


def test_score_matches_reference(engines):
    jeng, teng = engines
    toks = np.random.default_rng(1).integers(0, jeng.cfg.vocab, (2, 8))
    want, _ = jeng.serve("score", toks)
    got, _ = teng.serve("score", toks)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_report_lists_reference_components(engines):
    jeng, teng = engines
    jrep, trep = jeng.report(), teng.report()
    assert {(r["component"], r["group"]) for r in trep["components"]} == \
        {(r["component"], r["group"]) for r in jrep["components"]}
    assert trep["by_group"].keys() == jrep["by_group"].keys()
    assert trep["cold_start_s"] > 0


def test_concurrent_serves_equal_sequential():
    """Four threads serving on one engine at once get the tokens the same
    requests get one after the other (the per-engine serve lock)."""
    import threading
    eng = ServingEngine(t_reduced("recurrentgemma-2b"), batch_size=2,
                        prefill_len=8, max_len=24, device="cpu")
    eng.cold_start()
    rng = np.random.default_rng(8)
    reqs = [rng.integers(0, eng.cfg.vocab, (2, 8)) for _ in range(4)]
    want = [eng.serve("generate", t, max_new_tokens=6)[0] for t in reqs]
    got = [None] * len(reqs)

    def serve(i):
        got[i] = eng.serve("generate", reqs[i], max_new_tokens=6)[0]

    threads = [threading.Thread(target=serve, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_serve_takes_the_engines_batch_only():
    """As the reference's compiled executables, a serve's batch must be
    the engine's."""
    eng = ServingEngine(t_reduced("granite-8b"), batch_size=2,
                        prefill_len=8, max_len=16, device="cpu")
    eng.cold_start()
    with pytest.raises(ValueError, match="batch 1"):
        eng.serve("generate", np.zeros((1, 8), np.int32))


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(t_reduced("granite-8b"))


def test_int8_engine_gives_reference_tokens():
    """gemma2-9b with the int8 KV cache (its global layers'): 16 greedy
    tokens past the reduced window of 16 against the reference engine's."""
    jeng, teng = _engine_pair("gemma2-9b", kv_quant="int8")
    toks = np.random.default_rng(4).integers(0, jeng.cfg.vocab, (2, 8))
    want, _ = jeng.serve("generate", toks, max_new_tokens=16)
    got, _ = teng.serve("generate", toks, max_new_tokens=16)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_an_engine(arch):
    """Every configuration of the port, at full width, builds a
    ServingEngine with the reference's entries (nothing is materialized
    before the cold start)."""
    eng = ServingEngine(get_config(arch), device="cpu")
    want = ["generate"] + (["vision_generate"] if eng.cfg.vision_tokens
                           else []) \
        + (["transcribe"] if eng.cfg.encoder_layers else []) + ["score"]
    assert eng.entries() == want
    assert not any(c.ready for c in eng.registry.values())


def test_lazy_policy_defers_and_first_use_pays():
    """The port's twin of tests/test_serving.py's whisper test: under a
    lazy compile + frontend policy the cold start is shorter, and the
    first ``transcribe`` materializes its warm-up and the audio
    frontend (and nothing else)."""
    cfg = t_reduced("whisper-large-v3")
    kw = dict(batch_size=1, prefill_len=8, max_len=24, device="cpu")
    lazy = LoadPolicy(lazy_groups=frozenset({"compile", "frontend"}))
    eng = ServingEngine(cfg, policy=lazy, **kw)
    cold_lazy = eng.cold_start()
    eager = ServingEngine(cfg, **kw)
    cold_eager = eager.cold_start()
    assert cold_lazy < cold_eager, \
        "deferring the warm-ups must shrink the cold start"
    assert all(c.ready for c in eager.registry.values())
    assert [c.name for c in eng.registry.values() if c.ready] == \
        ["weights.core"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 8))
    out, lat = eng.serve("transcribe", toks, max_new_tokens=3)
    assert out.shape == (1, 3) and lat > 0
    assert [c.name for c in eng.registry.values() if c.ready] == \
        ["weights.core", "frontend.audio_encoder", "compile.transcribe"]


# ----------------------------------------------------------------- MoE
LAZY_EXPERTS = dict(lazy_groups=frozenset({"experts"}))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_full_width_moe_engine_constructs(arch):
    eng = ServingEngine(get_config(arch), device="cpu")
    n = get_config(arch).moe.n_experts
    assert [c.name for c in eng.registry.values()
            if c.group == "experts"] == [f"expert.{e}" for e in range(n)]
    assert not any(c.ready for c in eng.registry.values())


@pytest.fixture(scope="module")
def moe_engine():
    """The port's twin of tests/test_serving.py's MoE engine, with the
    experts deferred so that first routes materialize them."""
    eng = ServingEngine(t_reduced("granite-moe-1b-a400m"),
                        policy=LoadPolicy(**LAZY_EXPERTS), batch_size=1,
                        prefill_len=8, max_len=32, device="cpu")
    eng.cold_start()
    return eng


def test_moe_lazy_experts_materialize_on_route(moe_engine):
    eng = moe_engine
    cfg = eng.cfg
    assert not any(eng.registry[f"expert.{e}"].ready
                   for e in range(cfg.moe.n_experts))
    moe = eng._params["layers"]["scan"]["pos0"]["moe"]
    assert not moe["wi"].any() and not moe["wo"].any()  # blank at start
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 8))
    out, _ = eng.serve("generate", toks, max_new_tokens=4)
    assert out.shape == (1, 4)
    rep = eng.report()
    assert "expert_utilization" in rep
    util = rep["expert_utilization"]
    assert abs(sum(util.values()) - 1.0) < 1e-2
    routed = [e for e, m in enumerate(eng.expert_mass) if m > 0]
    assert routed
    for e in range(cfg.moe.n_experts):
        assert eng.registry[f"expert.{e}"].ready == (e in routed)
        assert bool(moe["wi"][:, e].any()) == (e in routed)


def test_moe_report_feeds_policy(moe_engine):
    rep = moe_engine.report()
    pol = LoadPolicy.from_report(rep)
    assert isinstance(pol.lazy_names, frozenset)
    for row in rep["components"]:
        if row["component"].startswith("expert."):
            assert row["utilization"] == \
                rep["expert_utilization"][row["component"]]
        if row["utilization"] < 0.02 and row["init_s"] > 0:
            assert row["component"] in pol.lazy_names


@pytest.fixture(scope="module")
def moe_reference_weights():
    """The reference engine's weights after an eager cold start (every
    expert drawn), as numpy."""
    jeng = JEngine(j_reduced("granite-moe-1b-a400m"), batch_size=2,
                   prefill_len=8, max_len=24)
    jeng.cold_start()
    return jax.tree.map(np.asarray, jeng._params)


def _carry_moe_weights(teng, np_full):
    """Swap the port's weights.core builder (the reference's tree with the
    experts blank) and its expert.<e> builders (each copies expert e's
    slices from the reference's drawn tree)."""
    def blank(tree, moe=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = blank(v, k == "moe")
            else:
                out[k] = np.zeros_like(v) if moe and k != "router" else v
        return out

    def expert(e):
        def visit(t_tree, np_tree):
            for k, v in t_tree.items():
                if k == "moe":
                    for w in ("wi", "wo"):
                        v[w][:, e] = torch.from_numpy(
                            np.array(np_tree[k][w][:, e]))
                elif isinstance(v, dict):
                    visit(v, np_tree[k])
        visit(teng._params["layers"], np_full["layers"])
        return e

    teng.registry["weights.core"].build = \
        lambda: from_numpy_tree(blank(np_full), "cpu")
    for e in range(teng.cfg.moe.n_experts):
        teng.registry[f"expert.{e}"].build = lambda e=e: expert(e)


@pytest.mark.parametrize("policy", ["eager", "lazy"])
def test_moe_generate_gives_reference_tokens(moe_reference_weights,
                                             policy):
    """Greedy tokens and routing mass of two requests, the reference's
    engine against the port's on the reference's weights.  Under the
    lazy policy both serve the first request's prefill with zero experts
    (the reference's order; see the module docstring)."""
    kw = dict(batch_size=2, prefill_len=8, max_len=24)
    jeng = JEngine(j_reduced("granite-moe-1b-a400m"), policy=(
        JPolicy(**LAZY_EXPERTS) if policy == "lazy" else None), **kw)
    teng = ServingEngine(t_reduced("granite-moe-1b-a400m"), policy=(
        LoadPolicy(**LAZY_EXPERTS) if policy == "lazy" else None),
        device="cpu", **kw)
    _carry_moe_weights(teng, moe_reference_weights)
    jeng.cold_start()
    teng.cold_start()
    assert [c.ready for c in teng.registry.values()] == \
        [c.ready for c in jeng.registry.values()]
    rng = np.random.default_rng(5)
    for _ in range(2):
        toks = rng.integers(0, jeng.cfg.vocab, (2, 8))
        want, _ = jeng.serve("generate", toks, max_new_tokens=6)
        got, _ = teng.serve("generate", toks, max_new_tokens=6)
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(teng.expert_mass, jeng.expert_mass)
    assert [c.ready for c in teng.registry.values()] == \
        [c.ready for c in jeng.registry.values()]
