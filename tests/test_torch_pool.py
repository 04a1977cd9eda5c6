"""PyTorch port: ``EnginePool`` and ``PoolSaturated`` against the
reference's, on the CPU (``device="cpu"``).

Each test of the reference's pool (``tests/test_fleet.py``'s EnginePool
tests on reduced qwen2.5-32b and granite-8b, ``tests/test_obs.py``'s
span and shed tests, ``tests/test_daemon.py``'s single-flight, legacy
and deferred-drop tests) runs here once per package, ``repro.serving``
and ``repro_torch.serving``, with the same assertions; each package's
spans and counters come from its own tracer and registry.  One more
test holds the port's pool, on the reference's weights, to the
reference pool's tokens.
"""

import gc
import threading
import time
import types
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.obs.metrics as j_metrics  # noqa: E402
import repro.obs.tracing as j_tracing  # noqa: E402
import repro.serving as j_serving  # noqa: E402
import repro_torch.obs.metrics as t_metrics  # noqa: E402
import repro_torch.obs.tracing as t_tracing  # noqa: E402
import repro_torch.serving as t_serving  # noqa: E402
from repro.api import save_report  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.core.adaptive.controller import SlimStartController  # noqa: E402
from repro.core.profiler.report import OptimizationReport  # noqa: E402
from repro.core.profiler.utilization import LibraryStats  # noqa: E402
from repro_torch.configs import get_reduced as t_reduced  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

PACKAGES = {
    "repro": types.SimpleNamespace(
        serving=j_serving, tracing=j_tracing, metrics=j_metrics,
        engine=lambda arch, **kw: j_serving.ServingEngine(j_reduced(arch),
                                                          **kw)),
    "repro_torch": types.SimpleNamespace(
        serving=t_serving, tracing=t_tracing, metrics=t_metrics,
        engine=lambda arch, **kw: t_serving.ServingEngine(
            t_reduced(arch), device="cpu", **kw)),
}


def _reset_obs(p):
    p.tracing.configure_tracing(enabled=False)
    p.tracing.get_tracer().clear()
    p.metrics.default_registry().reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """One package's serving, tracing and metrics modules; tracing off
    and the registry empty before and after."""
    p = PACKAGES[request.param]
    _reset_obs(p)
    yield p
    _reset_obs(p)


def _report(app: str) -> OptimizationReport:
    stat = LibraryStats(name="fakelib_hot", utilization=0.9, init_s=0.15,
                        init_share=0.75, runtime_samples=90, file="<x>")
    return OptimizationReport(application=app, e2e_s=0.2,
                              total_init_s=0.15, qualifies=True,
                              stats=[stat], defer_targets=[])


# ------------------------------------------------- tests/test_fleet.py
@pytest.fixture(scope="module", params=sorted(PACKAGES))
def engine_pool(request):
    p = PACKAGES[request.param]

    def builder(name):
        return lambda: p.engine(name, batch_size=1, prefill_len=8,
                                max_len=24)

    return p.serving.EnginePool({"qwen": builder("qwen2.5-32b"),
                                 "granite": builder("granite-8b")},
                                max_warm=1)


def test_engine_pool_warm_vs_cold_dispatch(engine_pool):
    toks = np.ones((1, 8), dtype=np.int32)
    out, lat_cold, path = engine_pool.dispatch("qwen", "generate", toks,
                                               max_new_tokens=2)
    assert path == "cold" and out.shape == (1, 2)
    out, lat_warm, path = engine_pool.dispatch("qwen", "generate", toks,
                                               max_new_tokens=2)
    assert path == "warm"
    assert lat_warm < lat_cold  # warm dispatch skips the cold start
    assert engine_pool.stats()["hits"] == 1
    assert engine_pool.stats()["misses"] == 1


def test_engine_pool_evicts_over_budget_and_drops_components(engine_pool):
    toks = np.ones((1, 8), dtype=np.int32)
    assert "qwen" in engine_pool.warm
    qwen_engine = engine_pool.warm["qwen"]
    out, _, path = engine_pool.dispatch("granite", "generate", toks,
                                        max_new_tokens=2)
    assert path == "cold"
    # max_warm=1: qwen was evicted and its components actually dropped
    assert list(engine_pool.warm) == ["granite"]
    assert "qwen" in engine_pool.evictions
    assert all(not c.ready for c in qwen_engine.registry.values())


def test_engine_pool_rewarm_is_a_controller_hook(engine_pool):
    reports = iter([_report("whatever") for _ in range(3)])
    ctl = SlimStartController(profile_fn=lambda: next(reports),
                              optimize_fn=lambda rep: None,
                              rewarm_fn=engine_pool.rewarm)
    ctl.force_profile()
    assert ctl.rewarms == 1 and ctl.rewarm_errors == []
    # the warm engine's policy was re-derived from live utilization:
    # components every request touches (weights.core) are now prewarm
    for eng in engine_pool.warm.values():
        assert "weights.core" in eng.policy.prewarm


def test_engine_pool_rewarm_takes_a_saved_report(engine_pool, tmp_path):
    """``rewarm`` accepts a saved report artifact's path (validated, not
    consulted) and refuses what is neither a report nor a path, and a
    file of another artifact kind."""
    path = save_report(_report("saved"), str(tmp_path / "rep.json"))
    out = engine_pool.rewarm(path)
    assert set(out) == set(engine_pool.warm)
    assert all("weights.core" in names for names in out.values())
    with pytest.raises(TypeError):
        engine_pool.rewarm(42)
    other = tmp_path / "trace.json"
    other.write_text('{"kind": "trace", "schema_version": 1}')
    with pytest.raises(ValueError, match="kind"):
        engine_pool.rewarm(str(other))


def test_engine_pool_unknown_model_raises(engine_pool):
    with pytest.raises(KeyError):
        engine_pool.dispatch("no-such-model", "generate", None)


def test_evicted_torch_engine_keeps_no_parameters():
    """Eviction drops ``weights.core`` and the warm-ups: the engine then
    holds no reference to its parameters, so their memory is freed."""
    pool = t_serving.EnginePool({
        m: (lambda m=m: PACKAGES["repro_torch"].engine(
            m, batch_size=1, prefill_len=8, max_len=16))
        for m in ("granite-8b", "recurrentgemma-2b")}, max_warm=1)
    toks = np.ones((1, 8), dtype=np.int32)
    pool.dispatch("granite-8b", "generate", toks, max_new_tokens=3)
    eng = pool.warm["granite-8b"]
    leaves = [weakref.ref(eng._params["embed"]),
              weakref.ref(eng._params["layers"]["scan"]["pos0"]["attn"]
                          ["wq"])]
    pool.dispatch("recurrentgemma-2b", "generate", toks, max_new_tokens=3)
    assert pool.evictions == ["granite-8b"]
    gc.collect()
    assert eng._params is None
    assert all(ref() is None for ref in leaves)


def test_torch_pool_gives_reference_pool_tokens():
    """The port's pool over the reference's weights (carried through
    ``convert.from_numpy_tree``) returns the reference pool's tokens on
    every path: cold, warm, and cold again after an eviction."""
    kw = dict(batch_size=2, prefill_len=8, max_len=24)
    weights = {}

    def j_builder(arch):
        def build():
            eng = PACKAGES["repro"].engine(arch, **kw)
            eng.cold_start()
            weights[arch] = jax.tree.map(np.asarray, eng._params)
            return eng
        return build

    def t_builder(arch):
        def build():
            eng = PACKAGES["repro_torch"].engine(arch, **kw)
            eng.registry["weights.core"].build = \
                lambda: from_numpy_tree(weights[arch], "cpu")
            return eng
        return build

    archs = ("granite-8b", "whisper-large-v3")
    jpool = j_serving.EnginePool({a: j_builder(a) for a in archs},
                                 max_warm=1)
    tpool = t_serving.EnginePool({a: t_builder(a) for a in archs},
                                 max_warm=1)
    rng = np.random.default_rng(4)
    for arch in ("granite-8b", "granite-8b", "whisper-large-v3",
                 "granite-8b"):
        toks = rng.integers(0, j_reduced(arch).vocab, (2, 8))
        want, _, jpath = jpool.dispatch(arch, "generate", toks,
                                        max_new_tokens=5)
        got, _, tpath = tpool.dispatch(arch, "generate", toks,
                                       max_new_tokens=5)
        assert tpath == jpath
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tpool.stats() == jpool.stats()


# --------------------------------------------------- tests/test_obs.py
class _InstantEngine:
    """Duck-typed ServingEngine: instant cold start and serve."""

    def __init__(self):
        self.cold_start_s = None
        self.registry = {}

    def cold_start(self):
        self.cold_start_s = 0.001
        return self.cold_start_s

    def serve(self, entry, tokens, **kw):
        return tokens, 0.0005


def test_engine_pool_cold_span_only_on_miss(pkg):
    pkg.tracing.configure_tracing(enabled=True)
    pool = pkg.serving.EnginePool({"m": _InstantEngine}, max_warm=2)
    pool.dispatch("m", "generate", [1])     # miss -> cold
    pool.dispatch("m", "generate", [1])     # hit -> warm
    spans = pkg.tracing.get_tracer().snapshot()
    dispatches = [s for s in spans if s.name == "engine_dispatch"]
    colds = [s for s in spans if s.name == "cold_start"]
    assert [d.attrs["path"] for d in dispatches] == ["cold", "warm"]
    assert len(colds) == 1
    assert colds[0].parent_id == dispatches[0].span_id
    snap = pkg.metrics.default_registry().snapshot()
    fam = {f["name"]: f for f in snap["families"]}
    ent = fam["repro_engine_dispatch_total"]
    series = {tuple(s["labels"]): s["value"] for s in ent["series"]}
    assert ent["labels"] == ["model", "path"]
    assert series[("m", "cold")] == 1
    assert series[("m", "warm")] == 1


def test_engine_pool_stats_breaks_out_pool_saturated_sheds(pkg):
    class _SlowColdEngine(_InstantEngine):
        def cold_start(self):
            time.sleep(0.2)
            self.cold_start_s = 0.2
            return self.cold_start_s

    pool = pkg.serving.EnginePool({"m": _SlowColdEngine}, max_warm=1,
                                  queue_depth=0)
    t = threading.Thread(target=lambda: pool.dispatch(
        "m", "generate", [1]))
    t.start()
    time.sleep(0.05)  # builder is mid-cold-start; depth 0 -> shed
    with pytest.raises(pkg.serving.PoolSaturated):
        pool.dispatch("m", "generate", [1])
    t.join(timeout=10)
    assert not t.is_alive()
    stats = pool.stats()
    assert stats["sheds"] == 1
    assert stats["shed_reasons"] == {"pool-saturated": 1}


# ------------------------------------------------ tests/test_daemon.py
class _StubEngine:
    """Duck-typed ServingEngine: slow cold start, instant serve."""

    def __init__(self, cold_s: float = 0.2):
        self._cold_s = cold_s
        self.cold_start_s = None
        self.registry = {}

    def cold_start(self):
        time.sleep(self._cold_s)
        self.cold_start_s = self._cold_s
        return self._cold_s

    def serve(self, entry, tokens, **kw):
        return "out", 0.001


def test_engine_pool_single_flight_and_shed(pkg):
    builds = []

    def builder():
        builds.append(1)
        return _StubEngine()

    pool = pkg.serving.EnginePool({"m": builder}, max_warm=1,
                                  queue_depth=2)
    paths, sheds = [], []

    def call():
        try:
            paths.append(pool.dispatch("m", "generate", None)[2])
        except pkg.serving.PoolSaturated:
            sheds.append(1)

    threads = [threading.Thread(target=call) for _ in range(5)]
    for t in threads:
        t.start()
        time.sleep(0.02)  # deterministic arrival order
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    # one build (single-flight), two waiters coalesced, two shed
    assert len(builds) == 1
    assert paths.count("cold") == 1 and paths.count("queued") == 2
    assert len(sheds) == 2
    stats = pool.stats()
    assert stats["sheds"] == 2 and stats["coalesced"] == 2
    assert stats["queue_wait_p99_s"] > 0
    # pool is warm now: no more waiting
    assert pool.dispatch("m", "generate", None)[2] == "warm"


def test_engine_pool_legacy_path_unchanged(pkg):
    pool = pkg.serving.EnginePool({"m": _StubEngine}, max_warm=1)
    assert pool.dispatch("m", "generate", None)[2] == "cold"
    assert pool.dispatch("m", "generate", None)[2] == "warm"
    assert "sheds" in pool.stats() and pool.stats()["sheds"] == 0


def test_engine_pool_eviction_defers_drop_during_inflight_serve(pkg):
    """Evicting a model while another thread is mid-serve on it must
    not drop its components under the request: the drop happens when
    the last in-flight serve returns."""
    class _Comp:
        def __init__(self):
            self.dropped = False

        def drop(self):
            self.dropped = True

    class _SlowServeEngine(_StubEngine):
        def __init__(self):
            super().__init__(cold_s=0.0)
            self.comp = _Comp()
            self.registry = {"c": self.comp}
            self.serving = threading.Event()
            self.release = threading.Event()

        def serve(self, entry, tokens, **kw):
            self.serving.set()
            assert self.release.wait(timeout=10)
            assert not self.comp.dropped  # must survive the eviction
            return "out", 0.001

    x_engine = _SlowServeEngine()
    pool = pkg.serving.EnginePool({"x": lambda: x_engine,
                                   "y": _StubEngine},
                                  max_warm=1, queue_depth=4)
    x_engine.release.set()                # let the cold serve through
    pool.dispatch("x", "generate", None)  # cold-start x
    x_engine.release.clear()
    x_engine.serving.clear()

    t = threading.Thread(
        target=lambda: pool.dispatch("x", "generate", None))
    t.start()
    assert x_engine.serving.wait(timeout=10)  # x is mid-serve
    pool.dispatch("y", "generate", None)      # evicts x (max_warm=1)
    assert "x" in pool.evictions
    assert not x_engine.comp.dropped          # drop deferred
    x_engine.release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert x_engine.comp.dropped              # dropped on serve exit
