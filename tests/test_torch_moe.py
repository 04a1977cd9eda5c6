"""PyTorch port: the MoE layer against ``repro.models.layers.moe_apply``.

The port computes the reference's grouped one-hot dispatch from indices
(top-k experts, each slot's place in its expert's queue, a gather into
an (E, G*C, D) buffer), so routing must match token for token: the
chosen experts and the kept (not dropped) slots are asserted equal, then
the output and aux within fp32 2e-5 / bf16 3e-2 (the reference's kernel
tolerances, tests/test_kernels.py).  ``torch.topk`` and ``lax.top_k``
may order exact ties differently; a routing mismatch reports the gap
between the k-th and (k+1)-th router probabilities of the rows at fault,
so a tie shows as a gap of 0.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _cfgs(arch, capacity_factor):
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    return (jcfg.with_(moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor)),
        tcfg.with_(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor)))


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2]))
            .astype(np.float32) for k, s in TL.moe_template(cfg).items()}


def _reference_routing(p, cfg, x, gs):
    """top_e and the kept mask, by the reference's own steps
    (repro/models/layers.py moe_apply)."""
    e = cfg.moe
    N, D = x.shape[0] * x.shape[1], x.shape[2]
    G = N // gs
    xg = x.reshape(G, gs, D)
    logits = jnp.einsum("gsd,de->gse", xg, p["router"],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = lax.top_k(probs, e.top_k)
    cap = max(int(e.capacity_factor * gs * e.top_k / e.n_experts), 1)
    onehot = jax.nn.one_hot(top_e, e.n_experts, dtype=jnp.float32)
    flat = onehot.reshape(G, gs * e.top_k, e.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    keep = ((pos < cap) * onehot).sum(-1) > 0
    return np.asarray(top_e), np.asarray(keep), np.asarray(probs)


def _assert_same_routing(got_e, want_e, probs, k):
    bad = np.argwhere((got_e != want_e).any(-1))
    if len(bad):
        srt = -np.sort(-probs, axis=-1)
        gaps = [float(srt[tuple(i)][k - 1] - srt[tuple(i)][k])
                for i in bad[:5]]
        raise AssertionError(
            f"routing differs at (group, token) {bad[:5].tolist()}: "
            f"k-th minus (k+1)-th router probability {gaps} (0 = a tie, "
            f"which torch.topk and lax.top_k may order differently)")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,group", [
    (2, 16, 8),   # 4 groups of 8, capacity 2: tokens are dropped
    (4, 1, None),  # the decode shape: one group of 4, capacity 1
    (2, 32, 64),  # one group of all 64 tokens, capacity 20
])
def test_moe_apply_matches_reference_with_drops(B, S, group, dtype):
    arch = "granite-moe-1b-a400m"
    jcfg, tcfg = _cfgs(arch, 1.25)
    jcfg, tcfg = jcfg.with_(dtype=dtype), tcfg.with_(dtype=dtype)
    p = _moe_params(tcfg, 3)
    x = np.random.default_rng(4).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    jx = jnp.asarray(x, dtype)
    tp = {k: v.to(tcfg.tdtype) for k, v in from_numpy_tree(p, "cpu")
          .items()}
    tx = torch.from_numpy(x).to(tcfg.tdtype)

    gs = min(group or tcfg.moe_group, B * S)
    want_e, want_keep, probs = _reference_routing(jp, jcfg, jx, gs)
    xg = tx.reshape(-1, gs, tcfg.d_model)
    _, _, top_e, pos, cap, _ = TL.moe_route(tp, tcfg, xg)
    _assert_same_routing(top_e.numpy(), want_e, probs, tcfg.moe.top_k)
    np.testing.assert_array_equal((pos < cap).numpy(), want_keep)
    if group == 8:
        assert not want_keep.all()  # the case drops slots

    wy, waux = JL.moe_apply(jp, jcfg, jx, group_size=group)
    ty, taux = TL.moe_apply(tp, tcfg, tx, group_size=group)
    assert ty.dtype == tcfg.tdtype
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(wy, np.float32), **TOL[dtype])
    np.testing.assert_allclose(taux["expert_load"].numpy(),
                               np.asarray(waux["expert_load"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(taux["moe_aux_loss"].item(),
                               float(waux["moe_aux_loss"]), rtol=1e-5)


def test_expert_load_counts_dropped_slots():
    """expert_load is each expert's share of the routed (token, slot)
    pairs, dropped ones included, so it sums to 1 whatever the capacity;
    a dropped slot adds nothing to its token's output."""
    _, tcfg = _cfgs("granite-moe-1b-a400m", 0.25)  # capacity 1 of 8 tokens
    p = from_numpy_tree(_moe_params(tcfg, 5), "cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 8, tcfg.d_model)).astype(np.float32))
    _, _, top_e, pos, cap, _ = TL.moe_route(p, tcfg, x)
    assert cap == 1 and (pos >= cap).any()
    y, aux = TL.moe_apply(p, tcfg, x)
    assert abs(aux["expert_load"].sum().item() - 1.0) < 1e-6
    counts = torch.bincount(top_e.flatten(), minlength=tcfg.moe.n_experts)
    torch.testing.assert_close(aux["expert_load"], counts.float() / 16)
    # a token whose every slot was dropped gets zeros
    all_dropped = (pos >= cap).all(-1)[0]
    assert torch.equal(y[0][all_dropped], torch.zeros_like(
        y[0][all_dropped]))


@pytest.mark.parametrize("group", [64, 128])
def test_moe_group_size_preserves_output(group):
    """tests/test_perf_features.py's check, run on the port and held
    against the reference: with the reduced config's dropless capacity
    a smaller dispatch group changes nothing."""
    arch = "granite-moe-1b-a400m"
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 64)).astype(np.int32)
    h1, _, _ = TM.forward(tcfg, tparams, torch.from_numpy(toks))
    h2, _, aux2 = TM.forward(tcfg.with_(moe_group=group), tparams,
                             torch.from_numpy(toks))
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=2e-4,
                               atol=2e-4)
    jh2, _, jaux2 = JM.forward(jcfg.with_(moe_group=group), jparams,
                               jnp.asarray(toks))
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(aux2["expert_load"].numpy(),
                               np.asarray(jaux2["expert_load"]),
                               rtol=1e-5, atol=1e-5)


def test_qk_norm_matches_reference():
    """olmoe's QK-norm: rms_norm over head_dim with zero-initialized
    (here random) scales, before rope."""
    jcfg, tcfg = j_reduced("olmoe-1b-7b"), t_reduced("olmoe-1b-7b")
    rng = np.random.default_rng(7)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.3
         for k, s in TL.attn_template(tcfg).items()}
    assert {"q_norm", "k_norm"} <= p.keys()
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    want = JL._project_qkv(jax.tree.map(jnp.asarray, p), jcfg,
                           jnp.asarray(x))
    got = TL._project_qkv(from_numpy_tree(p, "cpu"), tcfg,
                          torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
