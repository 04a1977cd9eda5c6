"""PyTorch port: ServingEngine against ``repro.serving.ServingEngine``
on reduced configs (dense granite-8b and hybrid recurrentgemma-2b), on
the CPU (device="cpu")."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
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


@pytest.fixture(scope="module", params=["granite-8b", "recurrentgemma-2b"])
def engines(request):
    """The reference engine and the port's, on the reference's weights
    (carried over by swapping the port's weights.core builder)."""
    jcfg, tcfg = j_reduced(request.param), t_reduced(request.param)
    kw = dict(batch_size=2, prefill_len=8, max_len=24)
    jeng = JEngine(jcfg, **kw)
    jeng.cold_start()
    np_params = jax.tree.map(np.asarray, jeng._params)
    teng = ServingEngine(tcfg, device="cpu", **kw)
    teng.registry["weights.core"].build = \
        lambda: from_numpy_tree(np_params, "cpu")
    teng.cold_start()
    return jeng, teng


def test_generate_gives_reference_tokens(engines):
    jeng, teng = engines
    toks = np.random.default_rng(0).integers(0, jeng.cfg.vocab, (2, 8))
    want, _ = jeng.serve("generate", toks, max_new_tokens=6)
    got, lat = teng.serve("generate", toks, max_new_tokens=6)
    assert lat > 0
    np.testing.assert_array_equal(got, np.asarray(want))


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


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(t_reduced("granite-8b"))


def test_engine_rejects_unported_config():
    with pytest.raises(NotImplementedError):
        ServingEngine(t_reduced("granite-moe-1b-a400m"), device="cpu")
