"""The model (PyTorch port of ``repro.models.model``), for every
architecture of the reference: decoders whose layers are
``attn_global``, ``attn_local``, ``rglru``, ``mlstm`` and ``slstm``
blocks, each (where ``cfg.d_ff`` > 0 or ``cfg.moe`` is set) with a
gated MLP or a capacity-routed MoE layer: the dense decoders, gemma2
and gemma3, recurrentgemma, xLSTM, the MoE decoders, pixtral and
whisper.

``window_pattern`` (gemma2, gemma3) maps each period position to an
``attn_local`` (sliding window, ring-buffer cache) or ``attn_global``
block; ``sandwich_norm`` adds ``ln1_post`` after an attention block's
output and ``ln2_post`` after the MLP's, each before its residual add;
``kv_quant="int8"`` keeps the global layers' k and v as int8 codes with
fp32 per-(token, kv-head) scales (``k_scale``/``v_scale``), while local
layers keep the model dtype.  mLSTM and sLSTM blocks carry fp32
recurrent state (``C``/``n``/``m`` and ``c``/``n``/``h``/``m``).

The two frontends are the reference's stubs.  pixtral's
``patch_embeds`` (B, vision_tokens, D) go through ``vision_proj`` and
fill the first positions in front of the text.  whisper's
``enc_frames`` (B, encoder_seq, D) run through the encoder
(``run_encoder``: ``attn_bidir`` blocks, a kind only the encoder uses),
and every decoder block cross-attends to its output; the encoder's k
and v of each block stay in its cache (``cross_k``/``cross_v``), written
by the prefill and read, never rewritten, by each decode step.  Where
``learned_pos_embed`` is set, positions add ``pos_embed[min(pos,
learned_pos_embed - 1)]`` (the reference's clamp).

Layers are grouped into periods as in the reference; parameters for
each period position are stacked over ``n_periods`` (``layers/scan/
pos0/...``), and layers that do not fill a whole period form a second
stacked group of depth 1 (``layers/rem_scan/pos{j}``), so a reference
parameter tree converts with no reshaping.  Where the reference drives
the stack with ``lax.scan``/``fori_loop``, the port runs a Python loop
over the stacked index; decode writes each layer's slice of the stacked
caches in place.

Public surface:
  block_pattern_of(cfg)   -> per-period block kinds
  model_template(cfg)     -> nested dict of ParamSpec
  init_params(cfg, generator, device) -> parameter tree
  init_cache(cfg, B, len, device)     -> stacked KV caches
  run_encoder(cfg, params, frames)    -> encoder output (B, T, D)
  forward(cfg, params, tokens, ...)   -> (hidden, caches, aux)
  loss_fn(cfg, params, batch)         -> (loss, metrics)
  prefill(cfg, params, tokens, ...)   -> (logits, caches, aux); with
                                         ``caches=`` it writes into them
  decode_step(cfg, params, token, pos, caches) -> (logits, caches)
  logical_axes(cfg)       -> the parameters' logical-axis tuples

Under a ``DeviceMesh`` (``partition.use_mesh``, parameters and caches as
DTensors) each layer's carry is constrained as in the reference
(``constrain(x, "batch", "seq", "embed")`` at the top of each period and
encoder block); without one ``constrain`` is the identity.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.kernels._build import is_dtensor
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.partition import (constrain, flat_rows, full,
                                          in_this_context, like, lookup,
                                          rows_out, split_last,
                                          to_placements)

f32 = torch.float32

# decoder block kinds
_KINDS = ("attn_global", "attn_local", "rglru", "mlstm", "slstm")
_STACKED = ("layers", "encoder/scan")  # template groups stacked by layer


# --------------------------------------------------------------------------
# block pattern / layer layout
# --------------------------------------------------------------------------

def block_pattern_of(cfg: ArchConfig) -> tuple[str, ...]:
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    if cfg.window_pattern:
        return tuple("attn_local" if w == "local" else "attn_global"
                     for w in cfg.window_pattern)
    return ("attn_global",)


def layer_layout(cfg: ArchConfig) -> tuple[tuple[str, ...], int, int]:
    """(pattern, n_periods, n_remainder)."""
    pat = block_pattern_of(cfg)
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


def _groups(cfg: ArchConfig):
    """(name, block kinds, depth) of each stacked layer group: ``scan``
    holds the whole periods; ``rem_scan`` the layers that do not fill one
    (recurrentgemma: 26 = 8*3 + 2; gemma3: 62 = 10*6 + 2), stacked to
    depth 1 as in the reference."""
    pat, n_per, n_rem = layer_layout(cfg)
    out = []
    if n_per > 0:
        out.append(("scan", pat, n_per))
    if n_rem:
        out.append(("rem_scan", pat[:n_rem], 1))
    return out


# --------------------------------------------------------------------------
# templates
# --------------------------------------------------------------------------

def block_template(cfg: ArchConfig, kind: str, *, encoder=False):
    """A decoder block of ``kind`` (with the cross sub-block where the
    config has an encoder) or, with ``encoder``, an encoder block
    (``attn_bidir``, a gated MLP even in an MoE config).  A block has an
    MLP (or MoE) where ``d_ff`` > 0 or ``moe`` is set, as in the
    reference (xLSTM has neither)."""
    if kind not in (("attn_bidir",) if encoder else _KINDS):
        raise ValueError(kind)
    D = cfg.d_model
    norm = lambda: ParamSpec((D,), ("embed",), init="zeros")  # noqa: E731
    t: dict[str, Any] = {"ln1": norm()}
    if kind.startswith("attn"):
        t["attn"] = L.attn_template(cfg)
        if cfg.sandwich_norm:
            t["ln1_post"] = norm()
    else:  # rglru, mlstm, slstm
        t[kind] = getattr(L, f"{kind}_template")(cfg)
    if not encoder and cfg.encoder_layers:
        t["ln_cross"] = norm()
        t["cross"] = L.attn_template(cfg)
    if cfg.d_ff > 0 or cfg.moe is not None:
        t["ln2"] = norm()
        if cfg.moe is not None and not encoder:
            t["moe"] = L.moe_template(cfg)
        else:
            t["mlp"] = L.mlp_template(cfg)
        if cfg.sandwich_norm:
            t["ln2_post"] = norm()
    return t


def _stack_specs(tmpl, n):
    return {k: (_stack_specs(s, n) if isinstance(s, dict) else
                ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                          s.scale))
            for k, s in tmpl.items()}


def model_template(cfg: ArchConfig):
    D, V = cfg.d_model, cfg.vocab
    t: dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), scale=1.0),
        "final_norm": ParamSpec((D,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    if cfg.learned_pos_embed:
        t["pos_embed"] = ParamSpec((cfg.learned_pos_embed, D),
                                   (None, "embed"), scale=0.02)
    if cfg.vision_tokens:
        t["vision_proj"] = ParamSpec((D, D), ("embed", "embed"))
    t["layers"] = {
        group: {f"pos{i}": _stack_specs(block_template(cfg, k), n)
                for i, k in enumerate(pattern)}
        for group, pattern, n in _groups(cfg)}
    if cfg.encoder_layers:
        t["encoder"] = {
            "scan": {"pos0": _stack_specs(
                block_template(cfg, "attn_bidir", encoder=True),
                cfg.encoder_layers)},
            "final_norm": ParamSpec((D,), ("embed",), init="zeros"),
        }
    return t


def logical_axes(cfg: ArchConfig):
    """Tree (mirroring the parameters) of logical-axis tuples."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else v.axes
                for k, v in t.items()}
    return walk(model_template(cfg))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(model_template(cfg)))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", *, blank_experts=False):
    """Random parameters drawn from ``generator`` on ``device``, directly
    in ``cfg.tdtype`` and one stacked layer slice at a time (no fp32
    transient of a full stacked weight).  ``blank_experts`` allocates the
    experts' ``moe/wi`` and ``moe/wo`` as zeros and draws nothing for
    them (the serving engine materializes them per expert).

    A stacked weight's std comes from its per-layer fan-in; the
    reference's stacked specs take the stack depth as fan-in.  Seeded
    inits are never compared across frameworks: weights cross through
    ``repro_torch.models.convert``.
    """
    def build(tmpl, stacked, path=""):
        out = {}
        for k, s in tmpl.items():
            if isinstance(s, dict):
                out[k] = build(s, stacked or f"{path}{k}" in _STACKED,
                               f"{path}{k}/")
                continue
            if blank_experts and path.endswith("moe/") and k in ("wi",
                                                                 "wo"):
                out[k] = torch.zeros(s.shape, dtype=cfg.tdtype,
                                     device=device)
                continue
            t = torch.empty(s.shape, dtype=cfg.tdtype, device=device)
            if stacked:
                inner = ParamSpec(s.shape[1:], s.axes[1:], s.init, s.scale)
                for i in range(s.shape[0]):
                    inner.fill_(t[i], generator)
            else:
                s.fill_(t, generator)
            out[k] = t
        return out

    return build(model_template(cfg), False)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def _block_cache(cfg: ArchConfig, kind: str, n: int, B: int,
                 cache_len: int):
    """The decode state of ``n`` stacked blocks of ``kind``, as {name:
    (shape, dtype, fill)}: k, v and slot positions (-1: empty) of an
    attention block (int8 k and v with fp32 scales on a global block
    under ``kv_quant="int8"``), fp32 recurrent state of a recurrent
    one."""
    K, hd, dt = cfg.n_kv_heads, cfg.head_dim, cfg.tdtype

    def zeros(*shape, dtype=f32, fill=0):
        return (n, B) + shape, dtype, fill
    if kind == "rglru":
        R = cfg.rglru_dim or cfg.d_model
        return {"h": zeros(R), "conv": zeros(cfg.conv_width - 1, R,
                                             dtype=dt)}
    if kind in ("mlstm", "slstm"):
        nh, dh = L._xlstm_heads(cfg)
        if kind == "mlstm":
            return {"C": zeros(nh, dh, dh), "n": zeros(nh, dh),
                    "m": zeros(nh)}
        return {"c": zeros(nh, dh), "n": zeros(nh, dh, fill=1e-6),
                "h": zeros(nh, dh), "m": zeros(nh, dh)}
    S = cache_len if kind == "attn_global" else min(cfg.window_size,
                                                    cache_len)
    quant = cfg.kv_quant == "int8" and kind == "attn_global"
    kv_dt = torch.int8 if quant else dt
    c = {"k": zeros(S, K, hd, dtype=kv_dt), "v": zeros(S, K, hd, dtype=kv_dt),
         "pos": zeros(S, dtype=torch.int32, fill=-1)}
    if quant:
        c["k_scale"] = zeros(S, K)
        c["v_scale"] = zeros(S, K)
    if cfg.encoder_layers:  # the encoder's k and v, for cross attention
        for key in ("cross_k", "cross_v"):
            c[key] = zeros(cfg.encoder_seq, K, hd, dtype=dt)
    return c


def cache_layout(cfg: ArchConfig, batch: int, cache_len: int):
    """``init_cache``'s tree with (shape, dtype, fill) leaves: what it
    holds, with nothing allocated."""
    return {group: {f"pos{i}": _block_cache(cfg, kind, n, batch, cache_len)
                    for i, kind in enumerate(pattern)}
            for group, pattern, n in _groups(cfg)}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device="cuda",
               mesh=None):
    """The stacked decode caches, filled as ``cache_layout`` says.  With
    ``mesh`` (a ``DeviceMesh``), DTensors placed by the sharding rules
    (``cache_pspecs``), each rank allocating its own shard only (local
    tensors on ``device``)."""
    if mesh is not None:
        from repro_torch.distributed.sharding import cache_pspecs
        specs = dict(_leaves(cache_pspecs(cfg, mesh, batch, cache_len)))

    def build(name, shape, dtype, fill):
        if mesh is None:
            return torch.full(shape, fill, dtype=dtype, device=device)
        return full(shape, fill, dtype, device, mesh,
                    to_placements(specs[name], mesh))

    def walk(t, prefix=""):
        return {k: (walk(v, f"{prefix}{k}/") if isinstance(v, dict) else
                    build(prefix + k, *v)) for k, v in t.items()}
    return walk(cache_layout(cfg, batch, cache_len))


# --------------------------------------------------------------------------
# block application
# --------------------------------------------------------------------------

def _apply_block(p, cfg, kind, x, positions, *, cache=None, decode=False,
                 make_cache=0, enc_out=None):
    """One residual block.  Returns (x, cache, aux): in decode, the
    attention cache updated in place or a recurrent block's new state;
    in prefill, the new cache when ``make_cache`` > 0 (with the encoder's
    k and v where the block cross-attends to ``enc_out``); aux, the MoE
    layer's router load and loss ({} without one).  Under
    ``sandwich_norm`` the attention and MLP outputs are normed
    (``ln1_post``, ``ln2_post``) before their residual adds."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind.startswith("attn"):
        if decode:
            y, cache = L.attn_decode(p["attn"], cfg, h, positions, cache,
                                     kind=kind)
        else:
            y, cache = L.attn_apply(p["attn"], cfg, h, positions,
                                    kind=kind, make_cache=make_cache)
        if cfg.sandwich_norm:
            y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    elif decode:  # rglru, mlstm, slstm: the new state replaces the old
        y, cache = getattr(L, f"{kind}_decode")(p[kind], cfg, h, cache)
    else:
        y, cache = getattr(L, f"{kind}_apply")(p[kind], cfg, h,
                                               make_cache=bool(make_cache))
    x = x + y
    if "cross" in p:
        h = L.rms_norm(x, p["ln_cross"], cfg.norm_eps)
        if decode:
            y, _ = L.attn_decode(p["cross"], cfg, h, positions, cache,
                                 kind="attn_cross", encoder_kv=(
                                     cache["cross_k"], cache["cross_v"]))
        else:
            K, hd = cfg.n_kv_heads, cfg.head_dim
            ek = split_last(L.dot(enc_out, p["cross"]["wk"]), K, hd)
            ev = split_last(L.dot(enc_out, p["cross"]["wv"]), K, hd)
            if cfg.qkv_bias:
                ek = ek + split_last(p["cross"]["bk"], K, hd)
                ev = ev + split_last(p["cross"]["bv"], K, hd)
            y, _ = L.attn_apply(p["cross"], cfg, h, positions,
                                kind="attn_cross", encoder_kv=(ek, ev))
            if make_cache:
                cache = {**cache, "cross_k": ek, "cross_v": ev}
        x = x + y
    aux = {}
    if "mlp" in p or "moe" in p:
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            y, aux = L.moe_apply(p["moe"], cfg, h)
        else:
            y = L.mlp_apply(p["mlp"], h)
        if cfg.sandwich_norm:
            y = L.rms_norm(y, p["ln2_post"], cfg.norm_eps)
        x = x + y
    return x, cache, aux


def _constrain_tree(tree, tmpl):
    return {k: (_constrain_tree(v, tmpl[k]) if isinstance(v, dict) else
                constrain(v, *tmpl[k].axes)) for k, v in tree.items()}


def constrain_like_params(cfg: ArchConfig, tree):
    """Pin a params-shaped tree (grads, fp32 accumulators) to the
    parameters' logical sharding; the identity outside a mesh (the
    reference's, which its step does not call either)."""
    return _constrain_tree(tree, model_template(cfg))


def _constrain_block_params(cfg, kind, p):
    """Pin one block's parameters to their logical sharding (the
    reference's; called nowhere there either)."""
    return _constrain_tree(p, block_template(cfg, kind))


def _zero_aux(cfg, x):
    if cfg.moe is None:
        return {}
    return {"expert_load": like(x, torch.zeros(
                (cfg.moe.n_experts,), dtype=f32, device=x.device)),
            "moe_aux_loss": like(x, torch.zeros((), dtype=f32,
                                                device=x.device))}


def _run_layers(cfg, params_l, x, positions, *, caches=None, decode=False,
                make_cache=0, enc_out=None, out_caches=None, remat=False):
    """Drive the stacked layer groups (``scan``, then ``rem_scan``): a
    loop over each group's stacked index.  ``remat`` checkpoints each
    block (``torch.utils.checkpoint``, non-reentrant): its activations
    are recomputed in the backward, as the reference's per-block
    ``jax.checkpoint`` (per block, not per period).

    Decode updates ``caches`` in place (a recurrent block's new state is
    copied into its stacked slice; the cross-attention k and v, which a
    decode step only reads, are never copied, so
    ``cfg.decode_skip_static_writes`` has nothing left to switch and is
    kept for ``asdict`` parity); prefill with ``make_cache`` > 0
    writes each layer's cache into a stacked cache: ``out_caches`` where
    given (every slot written, the empty ones as ``init_cache`` leaves
    them), else a fresh one.  Returns (x, caches or None, aux summed
    over the layers).
    """
    if make_cache:
        caches = _new_cache(cfg, x, make_cache) if out_caches is None \
            else out_caches
    aux_tot = _zero_aux(cfg, x)
    block = _checkpointed(_apply_block) if remat else _apply_block
    for group, i, t, kind, p_t in layer_slices(cfg, params_l):
        if i == 0 and not (decode and cfg.scan_layers):  # as the reference's
            x = constrain(x, "batch", "seq", "embed")
        c_t = _index(caches[group][f"pos{i}"], t) if caches else None
        x, nc, aux = block(p_t, cfg, kind, x, positions, cache=c_t,
                           decode=decode, make_cache=make_cache,
                           enc_out=enc_out)
        if not decode:  # decode_step returns no aux
            aux_tot = {a: v + aux[a] for a, v in aux_tot.items()}
        if decode or make_cache:
            for key, val in nc.items():
                if val is not c_t[key]:  # written in place already
                    c_t[key].copy_(val)
    return x, (caches if (decode or make_cache) else None), aux_tot


def layer_slices(cfg, params_l):
    """(group, i, t, kind, parameters) of every block of the stacked
    layer groups ``params_l`` in the order ``_run_layers`` drives them:
    slice ``t`` of the group's stack, at position ``i`` of its pattern
    (``i`` 0 starts a period)."""
    for group, pattern, n in _groups(cfg):
        layers = [_unstack(params_l[group][f"pos{i}"], n)
                  for i in range(len(pattern))]
        for t in range(n):
            for i, kind in enumerate(pattern):
                yield group, i, t, kind, layers[i][t]


def _new_cache(cfg, x, cache_len):
    """A fresh stacked cache for a prefill of ``x``; on a DTensor, placed
    by the sharding rules on ``x``'s mesh."""
    return init_cache(cfg, x.shape[0], cache_len, x.device,
                      mesh=x.device_mesh if is_dtensor(x) else None)


def _index(tree, t):
    return {k: (_index(v, t) if isinstance(v, dict) else v[t])
            for k, v in tree.items()}


def _unstack(tree, n):
    """The ``n`` per-layer slices of a stacked parameter group, each leaf
    split once (``torch.unbind``).  Under autograd the split's backward
    stacks the layers' grads once; indexing each layer apart would give
    each ``select`` a zero gradient as large as the whole stack."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
        for t in range(n):
            out[t][k] = parts[t]
    return out


def _checkpointed(fn):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept, under the
    mesh and act mode of the forward (``partition.in_this_context``)."""
    def run(*args, **kw):
        return torch.utils.checkpoint.checkpoint(
            in_this_context(fn), *args, use_reentrant=False, **kw)
    return run


# --------------------------------------------------------------------------
# encoder (whisper's stub frontend -> transformer encoder)
# --------------------------------------------------------------------------

def _encoder_block(p, cfg, x, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _ = L.attn_apply(p["attn"], cfg, h, positions, kind="attn_bidir")
    x = x + y
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h)


def run_encoder(cfg: ArchConfig, params, frames, *, remat=False):
    """frames: (B, encoder_seq, D) precomputed frame embeddings (the
    reference's stub).  Returns the encoder's output (B, encoder_seq, D)
    in the model dtype.  ``remat`` checkpoints each block."""
    x = frames.to(cfg.tdtype)
    B, S, _ = x.shape
    positions = _positions(x, B, S)
    enc = params["encoder"]
    block = _checkpointed(_encoder_block) if remat else _encoder_block
    for p in _unstack(enc["scan"]["pos0"], cfg.encoder_layers):
        x = constrain(x, "batch", "seq", "embed")
        x = block(p, cfg, x, positions)
    return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)


# --------------------------------------------------------------------------
# model entry points
# --------------------------------------------------------------------------

def _positions(x, B, S):
    """Positions 0..S-1 of every row, (B, S), beside ``x``."""
    return like(x, torch.arange(S, device=x.device).expand(B, S))


def _check_range(idx, n, what):
    """Fail on an index outside [0, n) (the reference clamps).  A CPU
    tensor is checked on the host (IndexError); on the card the check
    stays there (``torch._assert_async``), so a decode step adds no host
    sync and can be captured in a CUDA graph, and a bad index still fails
    loudly, at the next sync, as a device-side assert.  A DTensor's
    local shard is checked (each rank checks its own); a meta tensor has
    no values to check."""
    msg = f"{what} out of range [0, {n})"
    if is_dtensor(idx):
        idx = idx.to_local()
    if idx.device.type == "meta":
        return
    if idx.device.type == "cpu":
        if bool(((idx < 0) | (idx >= n)).any()):
            raise IndexError(msg)
    else:
        torch._assert_async(((idx >= 0) & (idx < n)).all(), msg)


def embed_tokens(cfg, params, tokens):
    _check_range(tokens, cfg.vocab, "token id")
    x = lookup(params["embed"], tokens)
    if cfg.scale_embed:
        x = x * like(x, torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _head(cfg, params, h):
    """fp32 logits, as the reference's preferred_element_type=f32.

    On the card, bf16 ``h`` and weight go into one GEMM with an fp32
    result and fp32 accumulation (``aten::mm.dtype``), neither widened
    first: bf16 products are exact in fp32, so only the summation order
    differs from widening both.  Everywhere else both are widened to
    fp32: on the CPU and the meta device (``mm.dtype`` has no CPU
    kernel), in fp32, on a DTensor, and where autograd needs the
    product's gradient (``mm.dtype`` has no derivative)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    grad = torch.is_grad_enabled() and (h.requires_grad or w.requires_grad)
    if h.is_cuda and h.dtype != f32 and not is_dtensor(h) and not grad:
        logits = torch.mm(h.reshape(-1, h.shape[-1]), w,
                          out_dtype=f32).view(*h.shape[:-1], w.shape[-1])
    else:
        logits = rows_out(torch.matmul(flat_rows(h.to(f32)), w.to(f32)))
    return L.softcap(logits, cfg.final_softcap)


def _add_pos_embed(cfg, params, x, positions):
    """x + the learned position embeddings, positions past the table
    clamped to its last row (as the reference does)."""
    if not cfg.learned_pos_embed:
        return x
    return x + lookup(params["pos_embed"],
                      positions.clamp(max=cfg.learned_pos_embed - 1))


def forward(cfg: ArchConfig, params, tokens, *, patch_embeds=None,
            enc_frames=None, make_cache=0, out_caches=None, remat=False):
    """Full-sequence forward from position 0.  Returns (hidden (B,S,D),
    caches, aux).

    pixtral: ``patch_embeds`` (B, vision_tokens, D) fill the first
    ``vision_tokens`` positions; ``tokens`` then holds the text after
    them.  whisper: ``enc_frames`` (B, encoder_seq, D) drive the encoder
    (zeros where absent, for text-only traffic); tokens are decoder ids.
    ``out_caches``: the stacked cache ``make_cache`` writes into (see
    ``prefill``).  ``remat``: checkpoint each block (training).
    """
    x = embed_tokens(cfg, params, tokens)
    if cfg.vision_tokens and patch_embeds is not None:
        vis = L.dot(patch_embeds.to(x.dtype), params["vision_proj"])
        x = torch.cat([vis, x], dim=1)
    B, S, _ = x.shape
    positions = _positions(x, B, S)
    x = _add_pos_embed(cfg, params, x, positions)
    enc_out = None
    if cfg.encoder_layers:
        if enc_frames is None:
            enc_frames = like(x, torch.zeros(
                (B, cfg.encoder_seq, cfg.d_model), dtype=x.dtype,
                device=x.device))
        enc_out = run_encoder(cfg, params, enc_frames, remat=remat)
    x, caches, aux = _run_layers(cfg, params["layers"], x, positions,
                                 make_cache=make_cache, enc_out=enc_out,
                                 out_caches=out_caches, remat=remat)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, caches, aux


def loss_fn(cfg: ArchConfig, params, batch):
    """Next-token loss.  batch: tokens (B, S), labels (B, S) with -1 =
    pad (and ``patch_embeds`` / ``enc_frames`` where the config takes
    them).  Returns (loss, metrics): ``ce_loss`` and ``loss``, and on an
    MoE config ``moe_aux_loss`` and ``expert_load`` (the loss adds 0.01
    of the aux loss).  Under ``cfg.remat == "block"`` every block is
    checkpointed.

    The head and the cross-entropy run in sequence chunks of
    ``min(S, max(cfg.loss_chunk // B, 256))`` tokens where that divides
    S into more than one chunk, each checkpointed, so only one chunk's
    fp32 (B, chunk, vocab) logits are alive at a time.
    """
    h, _, aux = forward(cfg, params, batch["tokens"],
                        patch_embeds=batch.get("patch_embeds"),
                        enc_frames=batch.get("enc_frames"),
                        remat=cfg.remat == "block")
    labels = batch["labels"]
    if cfg.vision_tokens and batch.get("patch_embeds") is not None:
        pad = labels.new_full((labels.shape[0], cfg.vision_tokens), -1)
        labels = torch.cat([pad, labels], dim=1)
    B, S, _ = h.shape

    def ce(h_chunk, l_chunk):
        # (B, s, V) fp32; under a mesh off the vocab axis, so the
        # logsumexp and the target's gather are local
        logits = constrain(_head(cfg, params, h_chunk), "batch", "seq",
                           None)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, l_chunk.clamp_min(0).long()[..., None])
        mask = (l_chunk >= 0).to(f32)
        return ((lse - tgt[..., 0]) * mask).sum(), mask.sum()

    chunk_s = (min(S, max(cfg.loss_chunk // max(B, 1), 256))
               if cfg.loss_chunk else 0)
    if chunk_s and S % chunk_s == 0 and chunk_s < S:
        ce_chunk = _checkpointed(ce)
        parts = [ce_chunk(h[:, i:i + chunk_s], labels[:, i:i + chunk_s])
                 for i in range(0, S, chunk_s)]
        tot = sum(t for t, _ in parts)
        cnt = sum(c for _, c in parts)
    else:
        tot, cnt = ce(h, labels)
    loss = tot / torch.clamp_min(cnt, 1.0)
    metrics = {"ce_loss": loss}
    if cfg.moe is not None:
        metrics["moe_aux_loss"] = aux["moe_aux_loss"]
        metrics["expert_load"] = aux["expert_load"]
        loss = loss + 0.01 * aux["moe_aux_loss"]
    metrics["loss"] = loss
    return loss, metrics


def prefill(cfg: ArchConfig, params, tokens, *, cache_len=None,
            patch_embeds=None, enc_frames=None, caches=None):
    """Prefill: forward + decode-cache construction.  Returns
    (last-token logits (B, V), caches, aux).  The cache holds
    ``cache_len`` slots, by default the prompt and the vision prefix.

    ``caches``: an existing cache tree of ``init_cache(cfg, B,
    cache_len)``'s shapes and types, written in place (every slot: the
    prefill's and, as empty ones, the rest) and returned; a CUDA graph's
    static caches take each request's prefill so, with no extra copy.
    """
    cache_len = cache_len or tokens.shape[1] + cfg.vision_tokens
    if caches is not None:
        _check_cache_tree(cfg, caches, tokens.shape[0], cache_len)
    h, caches, aux = forward(cfg, params, tokens, patch_embeds=patch_embeds,
                             enc_frames=enc_frames, make_cache=cache_len,
                             out_caches=caches)
    return _head(cfg, params, h[:, -1]), caches, aux


def _check_cache_tree(cfg, caches, batch, cache_len):
    """Raise ValueError unless ``caches`` has ``init_cache``'s leaves,
    shapes and types (checked against ``cache_layout``: nothing is
    allocated)."""
    want = dict(_leaves(cache_layout(cfg, batch, cache_len)))
    got = dict(_leaves(caches))
    bad = sorted(k for k in want.keys() | got.keys()
                 if k not in want or k not in got
                 or tuple(got[k].shape) != want[k][0]
                 or got[k].dtype != want[k][1])
    if bad:
        raise ValueError(f"prefill: the given caches differ from "
                         f"init_cache(cfg, {batch}, {cache_len}) at {bad}")


def decode_step(cfg: ArchConfig, params, token, pos, caches):
    """One decode step.  token: (B, 1) ids; pos: (B,) positions.

    Returns (logits (B, V), caches) with ``caches`` updated in place.
    A position must have a slot in every global cache; local caches are
    ring buffers and recurrent state has no slots, so they take any
    position >= 0.
    """
    slots = [caches[g][f"pos{i}"]["k"].shape[2]
             for g, pattern, _ in _groups(cfg)
             for i, kind in enumerate(pattern) if kind == "attn_global"]
    _check_range(pos, min(slots) if slots else 2**31 - 1,
                 "decode position")
    x = embed_tokens(cfg, params, token)
    x = _add_pos_embed(cfg, params, x, pos[:, None])
    x, caches, _ = _run_layers(cfg, params["layers"], x, pos,
                               caches=caches, decode=True)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(cfg, params, x[:, 0]), caches
