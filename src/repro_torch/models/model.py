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
  prefill(cfg, params, tokens, ...)   -> (logits, caches, aux); with
                                         ``caches=`` it writes into them
  decode_step(cfg, params, token, pos, caches) -> (logits, caches)
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import ParamSpec

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
                 cache_len: int, device):
    """The decode state of ``n`` stacked blocks of ``kind``: k, v and
    slot positions of an attention block (int8 k and v with fp32 scales
    on a global block under ``kv_quant="int8"``), fp32 recurrent state
    of a recurrent one."""
    K, hd, dt = cfg.n_kv_heads, cfg.head_dim, cfg.tdtype

    def zeros(*shape, dtype=f32):
        return torch.zeros((n, B) + shape, dtype=dtype, device=device)
    if kind == "rglru":
        R = cfg.rglru_dim or cfg.d_model
        return {"h": zeros(R), "conv": zeros(cfg.conv_width - 1, R,
                                             dtype=dt)}
    if kind in ("mlstm", "slstm"):
        nh, dh = L._xlstm_heads(cfg)
        if kind == "mlstm":
            return {"C": zeros(nh, dh, dh), "n": zeros(nh, dh),
                    "m": zeros(nh)}
        return {"c": zeros(nh, dh), "n": zeros(nh, dh).fill_(1e-6),
                "h": zeros(nh, dh), "m": zeros(nh, dh)}
    S = cache_len if kind == "attn_global" else min(cfg.window_size,
                                                    cache_len)
    quant = cfg.kv_quant == "int8" and kind == "attn_global"
    kv_dt = torch.int8 if quant else dt
    c = {"k": zeros(S, K, hd, dtype=kv_dt), "v": zeros(S, K, hd, dtype=kv_dt),
         "pos": zeros(S, dtype=torch.int32).fill_(-1)}
    if quant:
        c["k_scale"] = zeros(S, K)
        c["v_scale"] = zeros(S, K)
    if cfg.encoder_layers:  # the encoder's k and v, for cross attention
        for key in ("cross_k", "cross_v"):
            c[key] = zeros(cfg.encoder_seq, K, hd, dtype=dt)
    return c


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device="cuda"):
    return {group: {f"pos{i}": _block_cache(cfg, kind, n, batch, cache_len,
                                            device)
                    for i, kind in enumerate(pattern)}
            for group, pattern, n in _groups(cfg)}


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
            B, T, _ = enc_out.shape
            K, hd = cfg.n_kv_heads, cfg.head_dim
            ek = L.dot(enc_out, p["cross"]["wk"]).reshape(B, T, K, hd)
            ev = L.dot(enc_out, p["cross"]["wv"]).reshape(B, T, K, hd)
            if cfg.qkv_bias:
                ek = ek + p["cross"]["bk"].reshape(K, hd)
                ev = ev + p["cross"]["bv"].reshape(K, hd)
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


def _zero_aux(cfg, device):
    if cfg.moe is None:
        return {}
    return {"expert_load": torch.zeros((cfg.moe.n_experts,), dtype=f32,
                                       device=device),
            "moe_aux_loss": torch.zeros((), dtype=f32, device=device)}


def _run_layers(cfg, params_l, x, positions, *, caches=None, decode=False,
                make_cache=0, enc_out=None, out_caches=None):
    """Drive the stacked layer groups (``scan``, then ``rem_scan``): a
    loop over each group's stacked index.

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
        caches = init_cache(cfg, x.shape[0], make_cache, x.device) \
            if out_caches is None else out_caches
    aux_tot = _zero_aux(cfg, x.device)
    for group, pattern, n in _groups(cfg):
        for t in range(n):
            for i, kind in enumerate(pattern):
                p_t = _index(params_l[group][f"pos{i}"], t)
                c_t = _index(caches[group][f"pos{i}"], t) if caches \
                    else None
                x, nc, aux = _apply_block(p_t, cfg, kind, x, positions,
                                          cache=c_t, decode=decode,
                                          make_cache=make_cache,
                                          enc_out=enc_out)
                if not decode:  # decode_step returns no aux
                    aux_tot = {a: v + aux[a] for a, v in aux_tot.items()}
                if decode or make_cache:
                    for key, val in nc.items():
                        if val is not c_t[key]:  # written in place already
                            c_t[key].copy_(val)
    return x, (caches if (decode or make_cache) else None), aux_tot


def _index(tree, t):
    return {k: (_index(v, t) if isinstance(v, dict) else v[t])
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# encoder (whisper's stub frontend -> transformer encoder)
# --------------------------------------------------------------------------

def run_encoder(cfg: ArchConfig, params, frames):
    """frames: (B, encoder_seq, D) precomputed frame embeddings (the
    reference's stub).  Returns the encoder's output (B, encoder_seq, D)
    in the model dtype."""
    x = frames.to(cfg.tdtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    enc = params["encoder"]
    stack = enc["scan"]["pos0"]
    for t in range(stack["ln1"].shape[0]):
        p = _index(stack, t)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, _ = L.attn_apply(p["attn"], cfg, h, positions, kind="attn_bidir")
        x = x + y
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h)
    return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)


# --------------------------------------------------------------------------
# model entry points
# --------------------------------------------------------------------------

def _check_range(idx, n, what):
    """Fail on an index outside [0, n) (the reference clamps).  A CPU
    tensor is checked on the host (IndexError); on the card the check
    stays there (``torch._assert_async``), so a decode step adds no host
    sync and can be captured in a CUDA graph, and a bad index still fails
    loudly, at the next sync, as a device-side assert."""
    msg = f"{what} out of range [0, {n})"
    if idx.device.type == "cpu":
        if bool(((idx < 0) | (idx >= n)).any()):
            raise IndexError(msg)
    else:
        torch._assert_async(((idx >= 0) & (idx < n)).all(), msg)


def embed_tokens(cfg, params, tokens):
    _check_range(tokens, cfg.vocab, "token id")
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(cfg, params, h):
    """fp32 logits, as the reference's preferred_element_type=f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(h.to(f32), w.to(f32))
    return L.softcap(logits, cfg.final_softcap)


def _add_pos_embed(cfg, params, x, positions):
    """x + the learned position embeddings, positions past the table
    clamped to its last row (as the reference does)."""
    if not cfg.learned_pos_embed:
        return x
    return x + params["pos_embed"][
        positions.clamp(max=cfg.learned_pos_embed - 1)]


def forward(cfg: ArchConfig, params, tokens, *, patch_embeds=None,
            enc_frames=None, make_cache=0, out_caches=None):
    """Full-sequence forward from position 0.  Returns (hidden (B,S,D),
    caches, aux).

    pixtral: ``patch_embeds`` (B, vision_tokens, D) fill the first
    ``vision_tokens`` positions; ``tokens`` then holds the text after
    them.  whisper: ``enc_frames`` (B, encoder_seq, D) drive the encoder
    (zeros where absent, for text-only traffic); tokens are decoder ids.
    ``out_caches``: the stacked cache ``make_cache`` writes into (see
    ``prefill``).
    """
    x = embed_tokens(cfg, params, tokens)
    if cfg.vision_tokens and patch_embeds is not None:
        vis = L.dot(patch_embeds.to(x.dtype), params["vision_proj"])
        x = torch.cat([vis, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = _add_pos_embed(cfg, params, x, positions)
    enc_out = None
    if cfg.encoder_layers:
        if enc_frames is None:
            enc_frames = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                     dtype=x.dtype, device=x.device)
        enc_out = run_encoder(cfg, params, enc_frames)
    x, caches, aux = _run_layers(cfg, params["layers"], x, positions,
                                 make_cache=make_cache, enc_out=enc_out,
                                 out_caches=out_caches)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, caches, aux


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
    shapes and types (checked against a meta-device tree: nothing is
    allocated)."""
    want = dict(_leaves(init_cache(cfg, batch, cache_len, "meta")))
    got = dict(_leaves(caches))
    bad = sorted(k for k in want.keys() | got.keys()
                 if k not in want or k not in got
                 or got[k].shape != want[k].shape
                 or got[k].dtype != want[k].dtype)
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
