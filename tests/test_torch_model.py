"""PyTorch port: the models (dense, recurrent, MoE, pixtral's vision
prefix, whisper's encoder and cross attention) against ``repro.models``
on reduced configs, with the reference's weights carried over (JAX
init_params -> numpy -> repro_torch.models.convert), plus the numerics
the port pins.  pixtral's ``patch_embeds`` and whisper's ``enc_frames``
are drawn with numpy from a seed.

Deliberate differences from the reference (the first and the last are
pinned by tests below):
- out-of-range cache slots and token ids raise instead of clamping;
- a stacked weight's init std uses its per-layer fan-in;
- the serving engine keys each expert's init by crc32 of (seed, expert,
  layer path, leaf), where the reference folds in Python's ``hash``,
  which changes from process to process.

Tolerance 2e-3, the reference's own (tests/test_archs.py).  On the CPU
the port's attention runs the kernels' plain versions.
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

TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ["granite-8b", "qwen2.5-32b",  # qwen: qkv bias, untied head
         "recurrentgemma-2b",  # rglru + attn_local, rem_scan group
         "granite-moe-1b-a400m",  # MoE, tied head
         "olmoe-1b-7b",  # MoE with qk_norm, untied head
         "whisper-large-v3",  # encoder, cross attention, learned positions
         "pixtral-12b",  # vision prefix through vision_proj
         "gemma2-9b",  # local/global pattern, softcaps, sandwich norms
         "gemma3-27b",  # 5:1 local/global, qk_norm, rem_scan group
         "xlstm-350m"]  # mLSTM / sLSTM blocks, no MLP


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jcfg, tcfg, jparams, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _extras(cfg, B, seed):
    """The config's frontend inputs as numpy, drawn from ``seed``:
    pixtral's patch_embeds, whisper's enc_frames ({} for the others)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vision_tokens:
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _both(extras):
    """The same extras as jax arrays and as torch tensors."""
    return ({k: jnp.asarray(v) for k, v in extras.items()},
            {k: torch.from_numpy(v) for k, v in extras.items()})


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_converted_tree_matches_template(pair):
    arch, jcfg, tcfg, jparams, tparams = pair
    jl = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    tl = dict(_leaves(tparams))
    assert jl.keys() == tl.keys()
    for name, spec in _leaves(TM.model_template(tcfg)):
        assert tuple(tl[name].shape) == spec.shape, name
        np.testing.assert_array_equal(_np(tl[name]), jl[name])
    # the port's own init builds the same tree, dtypes and shapes
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in _leaves(own)} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tl.items()}


def _check_aux(got, want, what):
    """MoE aux (router load summed over layers, load-balancing loss);
    both {} for a model without MoE."""
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{what}: {k}")


def test_forward_prefill_decode_match_reference(pair):
    arch, jcfg, tcfg, jparams, tparams = pair
    B, T0, n_dec = 2, 8, 6
    total = T0 + n_dec
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (B, total)).astype(np.int32)
    jex, tex = _both(_extras(jcfg, B, 4))
    vt = jcfg.vision_tokens  # the vision prefix's positions come first

    jh, _, jaux = JM.forward(jcfg, jparams, jnp.asarray(toks), **jex)
    th, _, taux = TM.forward(tcfg, tparams, torch.from_numpy(toks), **tex)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL,
                               err_msg=f"{arch}: forward hidden")
    _check_aux(taux, jaux, f"{arch}: forward aux")

    jl, jc, jaux = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :T0]),
                              cache_len=vt + total, **jex)
    tl, tc, taux = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :T0]),
                              cache_len=vt + total, **tex)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                               err_msg=f"{arch}: prefill logits")
    _check_aux(taux, jaux, f"{arch}: prefill aux")
    jcn = dict(_leaves(jax.tree.map(np.asarray, jc)))
    tcn = dict(_leaves(to_numpy_tree(tc)))
    assert jcn.keys() == tcn.keys()
    for name in jcn:
        np.testing.assert_allclose(tcn[name], jcn[name], **TOL,
                                   err_msg=f"{arch}: cache {name}")

    for i in range(n_dec):
        pos = np.full((B,), vt + T0 + i, np.int32)
        tok = toks[:, T0 + i:T0 + i + 1]
        jl, jc = JM.decode_step(jcfg, jparams, jnp.asarray(tok),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"{arch}: decode step {i}")
    jcn = dict(_leaves(jax.tree.map(np.asarray, jc)))
    for name, arr in _leaves(to_numpy_tree(tc)):
        np.testing.assert_allclose(arr, jcn[name], **TOL,
                                   err_msg=f"{arch}: cache {name} after "
                                           f"decode")


def test_prefill_decode_matches_forward(pair):
    """The port's own cache correctness: prefill + decode steps against
    the teacher-forced forward (tests/test_archs.py, in the port)."""
    arch, _, tcfg, _, tparams = pair
    B, T0, n_dec = 2, 8, 5
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (B, T0 + n_dec)).astype(np.int32))
    _, ex = _both(_extras(tcfg, B, 5))
    vt = tcfg.vision_tokens
    h, _, _ = TM.forward(tcfg, tparams, toks, **ex)
    full = _np(TM._head(tcfg, tparams, h))[:, vt:]  # the text positions
    logits, caches, _ = TM.prefill(tcfg, tparams, toks[:, :T0],
                                   cache_len=vt + T0 + n_dec, **ex)
    np.testing.assert_allclose(_np(logits), full[:, T0 - 1], **TOL)
    for i in range(n_dec):
        pos = torch.full((B,), vt + T0 + i, dtype=torch.int32)
        logits, caches = TM.decode_step(tcfg, tparams,
                                        toks[:, T0 + i:T0 + i + 1], pos,
                                        caches)
        np.testing.assert_allclose(_np(logits), full[:, T0 + i], **TOL,
                                   err_msg=f"{arch}: decode step {i}")


@pytest.mark.parametrize("T0", [8, 20])  # 20 > recurrentgemma's window
def test_prefill_writes_into_given_caches(pair, T0):
    """``prefill(caches=)`` writes every leaf of a given cache tree in
    place, as a fresh prefill builds it: its own slots, and the rest
    empty (pos -1) whatever the tree held before; a tree of other shapes
    raises."""
    arch, _, tcfg, _, tparams = pair
    B, cache_len = 2, tcfg.vision_tokens + T0 + 4
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab, (B, T0)).astype(np.int32))
    _, ex = _both(_extras(tcfg, B, 6))
    want_logits, want, _ = TM.prefill(tcfg, tparams, toks,
                                      cache_len=cache_len, **ex)
    given = TM.init_cache(tcfg, B, cache_len, "cpu")
    for _, leaf in TM._leaves(given):  # stale contents, to be overwritten
        leaf.fill_(7)
    ptrs = {n: leaf.data_ptr() for n, leaf in TM._leaves(given)}
    logits, got, _ = TM.prefill(tcfg, tparams, toks, cache_len=cache_len,
                                caches=given, **ex)
    assert got is given
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    want = dict(TM._leaves(want))
    for name, leaf in TM._leaves(got):
        assert leaf.data_ptr() == ptrs[name], name
        torch.testing.assert_close(leaf, want[name], rtol=0, atol=0,
                                   msg=f"{arch}: {name}")
    with pytest.raises(ValueError, match="differ from init_cache"):
        TM.prefill(tcfg, tparams, toks, cache_len=cache_len,
                   caches=TM.init_cache(tcfg, B + 1, cache_len, "cpu"),
                   **ex)


# ------------------------------------------------------------ frontends
def _carried(arch, **kw):
    """(jcfg, tcfg, jparams, tparams) of the reduced arch (with ``kw``
    changes), the reference's weights carried into the port."""
    jcfg, tcfg = j_reduced(arch).with_(**kw), t_reduced(arch).with_(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_run_encoder_matches_reference():
    """whisper's encoder alone: bidirectional attention (no rope, no
    mask) over random frames, each layer's MLP, the final norm."""
    jcfg, tcfg, jparams, tparams = _carried("whisper-large-v3")
    frames = _extras(jcfg, 2, 6)["enc_frames"]
    want = JM.run_encoder(jcfg, jparams, jnp.asarray(frames))
    got = TM.run_encoder(tcfg, tparams, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, jcfg.encoder_seq, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_cross_decode_keeps_frames_past_the_position():
    """One cross-attention decode step at positions far below
    encoder_seq - 1 attends over every frame, as the reference's
    unmasked attention does (slot positions 0..T-1 against the decode
    position would drop the frames past it), with a query bias and the
    encoder's k and v as the reference hands them over."""
    jcfg, tcfg, _, _ = _carried("whisper-large-v3")
    rng = np.random.default_rng(12)
    B, T, K, hd = 2, jcfg.encoder_seq, jcfg.n_kv_heads, jcfg.head_dim
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.3
         for k, s in TL.attn_template(tcfg).items()}
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    ek = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    ev = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    pos = np.array([0, 3], np.int32)
    assert pos.max() < T - 1
    want, _ = JL.attn_decode(jax.tree.map(jnp.asarray, p), jcfg,
                             jnp.asarray(x), jnp.asarray(pos), {},
                             kind="attn_cross", encoder_kv=(
                                 jnp.asarray(ek), jnp.asarray(ev)))
    cache = {}
    got, kept = TL.attn_decode(from_numpy_tree(p, "cpu"), tcfg,
                               torch.from_numpy(x), torch.from_numpy(pos),
                               cache, kind="attn_cross", encoder_kv=(
                                   torch.from_numpy(ek),
                                   torch.from_numpy(ev)))
    assert kept is cache
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    # the whole model: decode steps at positions 2..4 of 24 frames
    jcfg, tcfg, jparams, tparams = _carried("whisper-large-v3")
    toks = rng.integers(0, jcfg.vocab, (B, 5)).astype(np.int32)
    jex, tex = _both(_extras(jcfg, B, 13))
    _, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :2]),
                          cache_len=8, **jex)
    _, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :2]),
                          cache_len=8, **tex)
    for i in range(2, 5):
        pos = np.full((B,), i, np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.from_numpy(
            toks[:, i:i + 1]), torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode position {i}")


def test_learned_positions_clamp_past_the_table():
    """Positions past ``learned_pos_embed`` take its last row, in the
    forward and in decode, as the reference's explicit clamp does."""
    jcfg, tcfg, jparams, tparams = _carried("whisper-large-v3",
                                            learned_pos_embed=4)
    B, T0 = 2, 6
    toks = np.random.default_rng(14).integers(
        0, jcfg.vocab, (B, T0 + 3)).astype(np.int32)
    jex, tex = _both(_extras(jcfg, B, 15))
    jh, _, _ = JM.forward(jcfg, jparams, jnp.asarray(toks), **jex)
    th, _, _ = TM.forward(tcfg, tparams, torch.from_numpy(toks), **tex)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    _, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :T0]),
                          cache_len=T0 + 3, **jex)
    _, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :T0]),
                          cache_len=T0 + 3, **tex)
    for i in range(T0, T0 + 3):  # all past the 4-row table
        pos = np.full((B,), i, np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.from_numpy(
            toks[:, i:i + 1]), torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode position {i}")
    x = TM._add_pos_embed(tcfg, tparams, torch.zeros((1, 2, tcfg.d_model)),
                          torch.tensor([[3, 40]]))
    np.testing.assert_array_equal(_np(x[0, 1]), _np(tparams["pos_embed"][3]))


def test_vision_prefix_fills_the_first_positions():
    """pixtral's prefill with patch embeddings: vision_proj of them sits
    in front of the text (positions 0..vt-1 of the cache), the logits
    and every cache leaf match the reference, and the prefix changes the
    text's logits."""
    jcfg, tcfg, jparams, tparams = _carried("pixtral-12b")
    B, T0, vt = 2, 5, jcfg.vision_tokens
    toks = np.random.default_rng(16).integers(
        0, jcfg.vocab, (B, T0)).astype(np.int32)
    jex, tex = _both(_extras(jcfg, B, 17))
    jl, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks), **jex)
    tl, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks), **tex)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    jcn = dict(_leaves(jax.tree.map(np.asarray, jc)))
    for name, arr in _leaves(to_numpy_tree(tc)):
        np.testing.assert_allclose(arr, jcn[name], **TOL, err_msg=name)
    pos = tc["scan"]["pos0"]["pos"]
    assert tuple(pos.shape) == (jcfg.n_layers, B, vt + T0)  # default length
    np.testing.assert_array_equal(_np(pos[0, 0]), np.arange(vt + T0))
    text_only, _, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert np.abs(_np(text_only) - _np(tl)).max() > 1e-3


def test_group_of_five_matches_reference():
    """qwen2.5-32b's G 5 (40 query heads over 8 kv heads) at reduced
    size: 10 query heads over 2 kv heads, the reference's reduced model
    and the port's with the same change, on the reference's weights --
    prefill and decode logits and the caches at 2e-3."""
    kw = dict(n_heads=10, n_kv_heads=2)
    jcfg = j_reduced("qwen2.5-32b").with_(**kw)
    tcfg = t_reduced("qwen2.5-32b").with_(**kw)
    assert tcfg.n_heads // tcfg.n_kv_heads == 5
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    B, T0, n_dec = 2, 8, 5
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab, (B, T0 + n_dec)).astype(np.int32)
    jl, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :T0]),
                           cache_len=T0 + n_dec)
    tl, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :T0]),
                           cache_len=T0 + n_dec)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                               err_msg="G 5: prefill logits")
    for i in range(n_dec):
        pos = np.full((B,), T0 + i, np.int32)
        tok = toks[:, T0 + i:T0 + i + 1]
        jl, jc = JM.decode_step(jcfg, jparams, jnp.asarray(tok),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"G 5: decode step {i}")
    jcn = dict(_leaves(jax.tree.map(np.asarray, jc)))
    for name, arr in _leaves(to_numpy_tree(tc)):
        np.testing.assert_allclose(arr, jcn[name], **TOL,
                                   err_msg=f"G 5: cache {name}")


# T0 20 > the reduced window of 16: the prefill rolls the ring; the ids
# of recurrentgemma's cases are their prompt lengths alone
@pytest.mark.parametrize("arch,T0", [
    pytest.param(arch, T0, id=str(T0) if arch == "recurrentgemma-2b"
                 else f"{arch}-{T0}")
    for arch in ("recurrentgemma-2b", "gemma2-9b", "gemma3-27b")
    for T0 in (4, 20)])
def test_decode_past_local_window_matches_reference(arch, T0):
    """The ring-buffer local cache stays right after the decode wraps the
    window (tests/test_archs.py, run against the port): recurrentgemma's
    local layers, gemma2's alternating local/global ones (softcaps,
    sandwich norms) and gemma3's 5:1 pattern with its remainder layers.
    Every decode step's logits against the reference's, and the last
    against the reference's teacher-forced forward, at its 5e-3."""
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    local = f"pos{TM.block_pattern_of(tcfg).index('attn_local')}"
    B = 2
    total = jcfg.window_size + 12  # force wraparound
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (B, total)).astype(np.int32)
    jh, _, _ = JM.forward(jcfg, jparams, jnp.asarray(toks))
    full = _np(JM._head(jcfg, jparams, jh))

    _, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :T0]),
                          cache_len=total)
    _, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :T0]),
                          cache_len=total)
    assert tc["scan"][local]["k"].shape[2] == jcfg.window_size
    np.testing.assert_array_equal(_np(tc["scan"][local]["pos"]),
                                  np.asarray(jc["scan"][local]["pos"]))
    dec = jax.jit(lambda p, t, pos, c: JM.decode_step(jcfg, p, t, pos, c))
    for i in range(T0, total):
        pos = np.full((B,), i, np.int32)
        tok = toks[:, i:i + 1]
        jl, jc = dec(jparams, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=5e-3, atol=5e-3,
                                   err_msg=f"decode position {i}")
    np.testing.assert_allclose(_np(tl), full[:, -1], rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(_np(tc["scan"][local]["pos"]),
                                  np.asarray(jc["scan"][local]["pos"]))


def test_rglru_primitives_match_reference():
    """causal_conv1d (fresh and with a carried state), _rglru_coeffs
    (softplus as logaddexp) and one rglru_decode step."""
    rng = np.random.default_rng(11)
    B, S, R, W = 2, 7, 24, 4
    x = rng.standard_normal((B, S, R)).astype(np.float32)
    w = rng.standard_normal((W, R)).astype(np.float32) / W
    b = rng.standard_normal((R,)).astype(np.float32)
    st = rng.standard_normal((B, W - 1, R)).astype(np.float32)
    for state in (None, st):
        jy, js = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), None if state is None
                                  else jnp.asarray(state))
        ty, ts = TL.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), None if state is None
                                  else torch.from_numpy(state))
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(ts), _np(js), rtol=0, atol=0)

    cfg = t_reduced("recurrentgemma-2b")
    D = cfg.d_model
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.3
         for k, s in TL.rglru_template(cfg.with_(d_model=D)).items()}
    p["lam"] = np.linspace(-4.0, 30.0, cfg.rglru_dim).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), from_numpy_tree(p, "cpu")
    u = rng.standard_normal((B, S, cfg.rglru_dim)).astype(np.float32)
    ja, jg = JL._rglru_coeffs(jp, jnp.asarray(u))
    ta, tg = TL._rglru_coeffs(tp, torch.from_numpy(u))
    np.testing.assert_allclose(_np(ta), _np(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-5, atol=1e-6)

    xd = rng.standard_normal((B, 1, D)).astype(np.float32)
    cache = {"h": rng.standard_normal((B, cfg.rglru_dim)).astype(np.float32),
             "conv": rng.standard_normal(
                 (B, W - 1, cfg.rglru_dim)).astype(np.float32)}
    jy, jc = JL.rglru_decode(jp, None, jnp.asarray(xd),
                             jax.tree.map(jnp.asarray, cache))
    ty, tc = TL.rglru_decode(tp, cfg, torch.from_numpy(xd),
                             from_numpy_tree(cache, "cpu"))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-4, atol=1e-4)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), rtol=1e-5,
                                   atol=1e-5)


def test_decode_positions_checked_only_against_global_caches():
    """A global cache bounds the decode position; recurrentgemma has only
    ring-buffer local caches and RG-LRU state, so any position >= 0
    decodes (and a negative one raises)."""
    cfg = t_reduced("recurrentgemma-2b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    caches = TM.init_cache(cfg, 1, 4, "cpu")
    assert caches["scan"]["pos2"]["k"].shape[2] == 4
    assert set(caches) == {"scan", "rem_scan"}
    tok = torch.zeros((1, 1), dtype=torch.int32)
    logits, caches = TM.decode_step(cfg, params, tok,
                                    torch.tensor([37], dtype=torch.int32),
                                    caches)
    assert torch.isfinite(logits).all()
    assert caches["scan"]["pos2"]["pos"][0, 0].tolist() == [-1, 37, -1, -1]
    with pytest.raises(IndexError):
        TM.decode_step(cfg, params, tok,
                       torch.tensor([-1], dtype=torch.int32), caches)


# ------------------------------------------------------------ pinned numerics
def test_out_of_range_indices_raise_where_reference_clamps():
    # cache_write: the reference's dynamic_update_slice clamps row 9 of a
    # 4-row cache to row 3; the port raises
    cache = np.zeros((1, 4, 2), np.float32)
    new = np.ones((1, 2), np.float32)
    got = np.asarray(JL.cache_write(jnp.asarray(cache), jnp.asarray(new),
                                    jnp.asarray([9])))
    assert got[0, 3].tolist() == [1.0, 1.0]
    with pytest.raises(IndexError):
        TL.cache_write(torch.from_numpy(cache), torch.from_numpy(new),
                       torch.tensor([9]))
    # token ids: the reference's embedding gather clamps, the port raises
    jcfg, tcfg = j_reduced("granite-8b"), t_reduced("granite-8b")
    params = {"embed": np.arange(jcfg.vocab * jcfg.d_model, dtype=np.float32)
              .reshape(jcfg.vocab, jcfg.d_model)}
    bad = np.array([[jcfg.vocab + 5]], np.int32)
    clamped = np.asarray(JM.embed_tokens(jcfg, {"embed": jnp.asarray(
        params["embed"])}, jnp.asarray(bad)))
    np.testing.assert_array_equal(clamped[0, 0], params["embed"][-1])
    with pytest.raises(IndexError):
        TM.embed_tokens(tcfg, from_numpy_tree(params, "cpu"),
                        torch.from_numpy(bad))
    # decode positions past the cache raise before any write
    caches = TM.init_cache(tcfg, 1, 4, "cpu")
    with pytest.raises(IndexError):
        TM.decode_step(tcfg, None, torch.zeros((1, 1), dtype=torch.int32),
                       torch.tensor([4], dtype=torch.int32), caches)


def test_mlp_uses_tanh_gelu():
    """jax.nn.gelu defaults to the tanh form; the exact (erf) gelu would
    miss the reference by more than the tolerance."""
    rng = np.random.default_rng(8)
    D, Fd = 16, 32
    x = rng.standard_normal((2, 3, D)).astype(np.float32) * 3
    p = {"wi": rng.standard_normal((D, 2 * Fd)).astype(np.float32),
         "wo": rng.standard_normal((Fd, D)).astype(np.float32)}
    want = np.asarray(JL.mlp_apply(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x)))
    tp = from_numpy_tree(p, "cpu")
    got = TL.mlp_apply(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    g, u = torch.from_numpy(x @ p["wi"]).chunk(2, dim=-1)
    erf = (torch.nn.functional.gelu(g) * u).numpy() @ p["wo"]
    assert np.abs(erf - want).max() > 1e-2


def test_fully_masked_row_is_uniform_not_nan():
    """Additive -1e30 masks: a row with no valid key averages v, as the
    reference does; a boolean -inf mask would give NaN."""
    rng = np.random.default_rng(9)
    B, S, K, G, hd = 1, 4, 1, 2, 8
    q = rng.standard_normal((B, 1, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    qp = np.zeros((B, 1), np.int32)
    kp = np.full((B, S), -1, np.int32)
    want = np.asarray(JL.attention(*map(jnp.asarray, (q, k, v)),
                                   q_positions=jnp.asarray(qp),
                                   kv_positions=jnp.asarray(kp)))
    got = TL.attention(*map(torch.from_numpy, (q, k, v)),
                       q_positions=torch.from_numpy(qp),
                       kv_positions=torch.from_numpy(kp)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0, 0, 0, 0], v[0, :, 0].mean(0),
                               rtol=2e-5, atol=2e-5)


def test_primitives_match_reference():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 2, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e7).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e7)),
        rtol=1e-4, atol=1e-4)
    scale = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                    1e-6).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        rtol=1e-5, atol=1e-5)
    # bf16 dot: fp32 accumulation, output cast back to bf16
    a = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    ja, jw = jnp.asarray(a).astype(jnp.bfloat16), \
        jnp.asarray(w).astype(jnp.bfloat16)
    got = TL.dot(torch.from_numpy(a).bfloat16(), torch.from_numpy(w)
                 .bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(JL.dot(ja, jw), np.float32),
                               rtol=1e-2, atol=1e-2)


def test_bf16_head_gives_fp32_logits():
    tcfg = t_reduced("granite-8b").with_(dtype="bfloat16")
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    h = torch.randn((2, tcfg.d_model), dtype=torch.bfloat16)
    assert TM._head(tcfg, params, h).dtype == torch.float32


def test_expert_init_keyed_stably_across_processes():
    """The engine's per-expert draws depend on (seed, expert, layer path,
    leaf) only: the same in a process with another hash seed, where the
    reference's ``hash``-keyed draws would change."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import torch\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.serving import LoadPolicy, ServingEngine\n"
        "eng = ServingEngine(get_reduced('granite-moe-1b-a400m'),\n"
        "    policy=LoadPolicy(lazy_groups=frozenset({'compile'})),\n"
        "    device='cpu')\n"
        "eng.cold_start()\n"
        "m = eng._params['layers']['scan']['pos0']['moe']\n"
        "print(repr([m[w][:, e].double().sum().item()\n"
        "            for e in range(8) for w in ('wi', 'wo')]))\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    sums = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=src, PYTHONHASHSEED=hash_seed)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        sums.append(out.stdout.strip())
    assert sums[0] == sums[1]
    per_expert = eval(sums[0])
    assert len(set(per_expert)) == len(per_expert)  # a draw per leaf


# ------------------------------------------------------------ int8 KV cache
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "gemma2-9b"])
def test_int8_kv_decode_greedy_equivalent(arch):
    """tests/test_perf_features.py's int8 test, run on the port: decode
    over the int8 KV cache keeps greedy decoding equivalent to the
    teacher-forced forward (argmax agreement) with logits within the
    reference's quantization bound (0.25 of their scale); and every step
    against the reference's own int8 decode, at 2e-3, with each cache's
    int8 codes within one step of the reference's (a value on a rounding
    boundary may land either side) and its scales at 2e-3."""
    jcfg = j_reduced(arch).with_(kv_quant="int8")
    tcfg = t_reduced(arch).with_(kv_quant="int8")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    B, T0, n_dec = 2, 8, 4
    tokens = np.array(jax.random.randint(
        jax.random.PRNGKey(2), (B, T0 + n_dec), 0, jcfg.vocab, jnp.int32))
    h, _, _ = TM.forward(tcfg, tparams, torch.from_numpy(tokens))
    full = _np(TM._head(tcfg, tparams, h))
    _, jc, _ = JM.prefill(jcfg, jparams, jnp.asarray(tokens[:, :T0]),
                          cache_len=T0 + n_dec)
    _, tc, _ = TM.prefill(tcfg, tparams, torch.from_numpy(tokens[:, :T0]),
                          cache_len=T0 + n_dec)
    for i in range(n_dec):
        pos = np.full((B,), T0 + i, np.int32)
        tok = tokens[:, T0 + i:T0 + i + 1]
        jl, jc = JM.decode_step(jcfg, jparams, jnp.asarray(tok),
                                jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc)
        got, ref = _np(tl), full[:, T0 + i]
        assert (got.argmax(-1) == ref.argmax(-1)).all(), \
            f"{arch}: greedy divergence at step {i}"
        assert np.abs(got - ref).max() / np.abs(ref).max() < 0.25
        np.testing.assert_allclose(got, _np(jl), **TOL,
                                   err_msg=f"{arch}: int8 decode step {i}")
    jcn = dict(_leaves(jax.tree.map(np.asarray, jc)))
    for name, leaf in _leaves(tc):
        if leaf.dtype == torch.int8:
            assert jcn[name].dtype == np.int8, name
            diff = np.abs(leaf.numpy().astype(np.int32)
                          - jcn[name].astype(np.int32))
            assert diff.max() <= 1, name
        else:
            np.testing.assert_allclose(_np(leaf), jcn[name], **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "gemma2-9b"])
def test_int8_cache_dtype(arch):
    """tests/test_perf_features.py's dtype test, on the port and against
    the reference's tree: global layers hold int8 k and v with fp32
    ``k_scale``/``v_scale`` (B, S, K); local layers keep the model
    dtype."""
    jcfg = j_reduced(arch).with_(kv_quant="int8")
    tcfg = t_reduced(arch).with_(kv_quant="int8")
    want = {n: np.asarray(v) for n, v in _leaves(
        jax.tree.map(np.asarray, JM.init_cache(jcfg, 2, 16)))}
    got = dict(_leaves(TM.init_cache(tcfg, 2, 16, "cpu")))
    assert got.keys() == want.keys()
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == want[name].dtype.name, name
    pattern = TM.block_pattern_of(tcfg)
    for i, kind in enumerate(pattern):
        blk = TM.init_cache(tcfg, 2, 16, "cpu")["scan"][f"pos{i}"]
        quant = kind == "attn_global"
        assert (blk["k"].dtype == torch.int8) == quant, kind
        assert ("k_scale" in blk) == quant, kind
        if quant:
            assert blk["k_scale"].dtype == torch.float32
            assert tuple(blk["k_scale"].shape) == tuple(blk["k"].shape[:-1])


def test_kv_quantize_matches_reference():
    """Per (token, kv-head) codes and scales, rounding half to even as
    jnp.round, an all-zero row (scale floored at 1e-8) and values that
    land exactly on .5 steps."""
    rng = np.random.default_rng(21)
    t = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 4
    t[0, 0, 0] = 0.0
    # scale 254 / 127 = 2 exactly; the other values / 2 are -6.5 .. 7.5
    t[1, 2, 1] = 2 * (np.arange(16, dtype=np.float32) - 7.5)
    t[1, 2, 1, 0] = 254.0
    jq, js = JL.kv_quantize(jnp.asarray(t))
    tq, ts = TL.kv_quantize(torch.from_numpy(t))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=0)
    assert ts[0, 0, 0].item() == pytest.approx(1e-8)
    assert ts[1, 2, 1].item() == 2.0
    assert tq[1, 2, 1, 1:].tolist() == [-6, -6, -4, -4, -2, -2, 0, 0, 2, 2,
                                        4, 4, 6, 6, 8]
