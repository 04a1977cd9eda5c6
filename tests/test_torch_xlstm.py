"""PyTorch port: xLSTM's mLSTM and sLSTM blocks against
``repro.models.layers`` (apply over a sequence, with the final state it
leaves, and one decode step from a random state), on random parameters
and inputs drawn with numpy from a seed, plus the reduced xlstm-350m's
cache tree and its decode state through the whole model.

The port runs both scans as a Python loop over time with fp32 state,
as the reference's ``lax.scan`` does; sLSTM's four recurrent products
are one product with the gates' weights stacked (each output is the
same dot product).  Tolerances: 2e-4 for a layer in fp32, 2e-3 (the
reference's, tests/test_archs.py) for the model.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_numpy_tree, to_numpy_tree,
)

LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "xlstm-350m"
KINDS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _params(kind, cfg, rng, gate_scale=1.0):
    """Random parameters of the block's template: normal / sqrt(fan-in)
    weights (the template's own scales), gate weights times
    ``gate_scale``."""
    tmpl = getattr(TL, f"{kind}_template")(cfg)
    out = {}
    for name, s in tmpl.items():
        std = s.std() * (gate_scale if name in ("wi", "wf", "ri", "rf")
                         else 1.0)
        out[name] = (rng.standard_normal(s.shape) * std).astype(np.float32)
    return out


def _state(kind, cfg, B, rng):
    """A random decode state of the block (a positive normalizer)."""
    nh = cfg.lru_heads
    dh = cfg.d_model // nh
    if kind == "mlstm":
        st = {"C": rng.standard_normal((B, nh, dh, dh)),
              "n": rng.standard_normal((B, nh, dh)),
              "m": rng.standard_normal((B, nh))}
    else:
        st = {"c": rng.standard_normal((B, nh, dh)),
              "n": rng.uniform(0.5, 2.0, (B, nh, dh)),
              "h": rng.standard_normal((B, nh, dh)),
              "m": rng.standard_normal((B, nh, dh))}
    return {k: v.astype(np.float32) for k, v in st.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("gate_scale", [1.0, 40.0])  # 40: large gate logs
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_apply_matches_reference(kind, gate_scale):
    """The block over 11 steps, its output and the state it leaves; with
    gate weights 40x their init the gate logs reach tens, where an
    unstabilized exp would overflow."""
    cfg = t_reduced(ARCH)
    rng = np.random.default_rng(1 if kind == "mlstm" else 2)
    p = _params(kind, cfg, rng, gate_scale)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    want_y, want_c = getattr(JL, f"{kind}_apply")(
        jax.tree.map(jnp.asarray, p), j_reduced(ARCH), jnp.asarray(x),
        make_cache=True)
    got_y, got_c = getattr(TL, f"{kind}_apply")(
        from_numpy_tree(p, "cpu"), cfg, torch.from_numpy(x),
        make_cache=True)
    assert np.isfinite(_np(got_y)).all()
    np.testing.assert_allclose(_np(got_y), _np(want_y), **LAYER_TOL)
    assert sorted(got_c) == sorted(KINDS[kind])
    for k in KINDS[kind]:
        assert got_c[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(got_c[k]), _np(want_c[k]),
                                   **LAYER_TOL, err_msg=k)
    _, none = getattr(TL, f"{kind}_apply")(
        from_numpy_tree(p, "cpu"), cfg, torch.from_numpy(x))
    assert none is None


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_reference(kind):
    """Three decode steps from a random state, each step's output and
    new state against the reference's."""
    cfg = t_reduced(ARCH)
    rng = np.random.default_rng(3 if kind == "mlstm" else 4)
    p = _params(kind, cfg, rng)
    jp, tp = jax.tree.map(jnp.asarray, p), from_numpy_tree(p, "cpu")
    st = _state(kind, cfg, 2, rng)
    jst, tst = jax.tree.map(jnp.asarray, st), from_numpy_tree(st, "cpu")
    for step in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = getattr(JL, f"{kind}_decode")(jp, j_reduced(ARCH),
                                                jnp.asarray(x), jst)
        ty, tst = getattr(TL, f"{kind}_decode")(tp, cfg,
                                                torch.from_numpy(x), tst)
        np.testing.assert_allclose(_np(ty), _np(jy), **LAYER_TOL,
                                   err_msg=f"step {step}")
        for k in KINDS[kind]:
            np.testing.assert_allclose(_np(tst[k]), _np(jst[k]),
                                       **LAYER_TOL,
                                       err_msg=f"step {step}: {k}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_apply_equals_decode_steps(kind):
    """The port's own consistency: the sequence's output and final state
    equal those of decode steps from the initial state, one token at a
    time."""
    cfg = t_reduced(ARCH)
    rng = np.random.default_rng(5)
    p = from_numpy_tree(_params(kind, cfg, rng), "cpu")
    x = torch.from_numpy(rng.standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32))
    y, final = getattr(TL, f"{kind}_apply")(p, cfg, x, make_cache=True)
    st = {k: v[0] for k, v in TM.init_cache(cfg, 2, 1, "cpu")["scan"][
        f"pos{('mlstm', 'slstm').index(kind)}"].items()}
    for t in range(x.shape[1]):
        yt, st = getattr(TL, f"{kind}_decode")(p, cfg, x[:, t:t + 1], st)
        torch.testing.assert_close(yt[:, 0], y[:, t], **LAYER_TOL)
    for k in KINDS[kind]:
        torch.testing.assert_close(st[k], final[k], **LAYER_TOL)


def test_cache_tree_matches_reference():
    """init_cache: the reference's leaves, shapes, fp32 dtypes and initial
    values (sLSTM's normalizer starts at 1e-6), and no MLP leaves in the
    template (d_ff = 0)."""
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    want = dict(jax.tree_util.tree_flatten_with_path(
        JM.init_cache(jcfg, 2, 9))[0])
    want = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in want.items()}
    got = dict(TM._leaves(TM.init_cache(tcfg, 2, 9, "cpu")))
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert leaf.dtype == torch.float32, name
        np.testing.assert_array_equal(_np(leaf), want[name], err_msg=name)
    blocks = TM.model_template(tcfg)["layers"]["scan"]
    assert sorted(blocks["pos0"]) == ["ln1", "mlstm"]
    assert sorted(blocks["pos1"]) == ["ln1", "slstm"]


def test_decode_state_matches_reference_through_the_model():
    """The whole reduced model: prefill then 6 decode steps, every step's
    logits and the stacked recurrent state after them against the
    reference's."""
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    B, T0, n_dec = 2, 5, 6
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab, (B, T0 + n_dec)).astype(np.int32)
    _, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :T0]))
    _, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :T0]))
    for i in range(T0, T0 + n_dec):
        pos = np.full((B,), i, np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.from_numpy(
            toks[:, i:i + 1]), torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-3, atol=2e-3,
                                   err_msg=f"decode position {i}")
    jcn = {"/".join(k.key for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(jc)[0]}
    for name, arr in TM._leaves(to_numpy_tree(tc)):
        np.testing.assert_allclose(arr, jcn[name], rtol=2e-3, atol=2e-3,
                                   err_msg=name)
