"""Building blocks of the model (PyTorch port of
``repro.models.layers``: global, local, bidirectional (encoder) and
cross attention with optional QK-norm and an optional int8 KV cache,
the gated MLP, the capacity-routed MoE layer, the RG-LRU recurrent
block and xLSTM's mLSTM and sLSTM blocks).

Each block keeps the reference's three parts: ``*_template(cfg)`` (a
flat dict ``name -> ParamSpec``), ``*_apply`` (full sequence) and
``*_decode`` (one token with a KV cache).  Parameter names, shapes and
the ``(in, out)`` matrix layout are the reference's, so a parameter
tree converts with no transposes (``repro_torch.models.convert``).

Attention and the RG-LRU scan go through ``repro_torch.kernels.ops``:
on a CUDA tensor that launches the hand-written kernels, on a CPU
tensor it runs their plain PyTorch versions.  ``attention`` below is the
reference's einsum path in model layout, kept as the plain yardstick
the tests hold the kernel wrappers against.  Three paths have no Pallas
kernel in the reference and stay plain PyTorch on every device: decode
over an int8 KV cache (``_attn_decode_quant``, the reference's XLA
path) and the mLSTM and sLSTM scans (a Python loop over time, fp32
state).

Numerics policy (as the reference): parameters and activations are
``cfg.tdtype``; matmuls accumulate in fp32 (cuBLAS and the CPU GEMMs do
so for bf16 inputs); norms, softmax and rope run in fp32 and cast back.
Unlike the reference, which clamps out-of-range cache slots
(``lax.dynamic_update_slice``), the port raises on them.

Under a ``DeviceMesh`` the parameters, caches and activations are
DTensors; ``constrain`` pins activations at the reference's sites (q, k
and v before a prefill's attention, the MLP's hidden, the MoE dispatch),
and tensors a block builds itself (rope angles, zero states, index
vectors) meet them as replicated DTensors (``partition.like``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels._build import is_dtensor
from repro_torch.kernels.loops import time_loop
from repro_torch.models.config import ArchConfig
from repro_torch.models.partition import (constrain, flat_rows,
                                          gather_dim, like, lookup,
                                          merge_last, rows_out,
                                          shard_offset, split_last)

f32 = torch.float32
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axes, len == ndim
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: Optional[float] = None  # None => 1/sqrt(fan_in)

    def std(self) -> float:
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return self.scale if self.scale is not None else \
            1.0 / math.sqrt(max(fan_in, 1))

    def fill_(self, out: torch.Tensor, generator: torch.Generator):
        """Initialize ``out`` (of this spec's shape) in place."""
        if self.init == "zeros":
            return out.zero_()
        if self.init == "ones":
            return out.fill_(1.0)
        return out.normal_(0.0, self.std(), generator=generator)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def dot(x, w):
    """Matmul with fp32 accumulation, output in x.dtype."""
    return rows_out(torch.matmul(flat_rows(x), w))


def rms_norm(x, scale, eps):
    x32 = x.to(f32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(f32))).to(x.dtype)


def log_sigmoid(x):
    """log(sigmoid(x)); on a DTensor as -logaddexp(0, -x) (the same
    function: DTensor has no sharding rule for logsigmoid's backward)."""
    if is_dtensor(x):
        return -torch.logaddexp(torch.zeros_like(x), -x)
    return F.logsigmoid(x)


def softcap(x, cap):
    """cap * tanh(x / cap); x is left alone.  Outside autograd only one
    new tensor is made (the logits it caps may be GBs); where x requires
    grad the ops are out of place (tanh's backward reads its output), and
    on a DTensor (which may be a partial sum, where tanh does not apply
    shard by shard)."""
    if cap is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad or is_dtensor(x):
        return torch.tanh(x / cap) * cap
    return (x / cap).tanh_().mul_(cap)


def rope(x, positions, theta):
    """Rotary embedding, half-rotation convention (llama/gemma).

    x: (B, S, ..., head_dim) with any number of middle (head) dims;
    positions: (B, S) absolute positions.
    """
    half = x.shape[-1] // 2
    freq = like(positions, theta ** (
        -torch.arange(0, half, dtype=f32, device=x.device) / half))
    ang = positions[..., None].to(f32) * freq  # (B, S, half)
    extra = x.ndim - positions.ndim - 1  # head dims to broadcast over
    ang = ang.reshape(ang.shape[:-1] + (1,) * extra + (half,))
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_scores(q, k, scale, cap):
    # q: (B, S, K, G, hd), k: (B, T, K, hd) -> (B, K, G, S, T) fp32
    s = torch.einsum("bskgd,btkd->bkgst", q.to(f32), k.to(f32))
    return softcap(s * scale, cap)


def attention(q, k, v, *, q_positions, kv_positions, causal=True,
              window=None, softcap_val=None, chunk_q=0, chunk_kv=0):
    """Masked multi-query attention (GQA layout), the reference's einsum
    path.

    q: (B, S, K, G, hd); k, v: (B, T, K, hd).
    q_positions: (B, S) absolute positions of queries.
    kv_positions: (B, T) absolute positions of keys (-1 = invalid slot).
    window: if set, keys with q_pos - k_pos >= window are masked (local).
    chunk_q/chunk_kv: if both > 0 (and S > 1), the online-softmax path
    (``_chunked_attention``).
    """
    if chunk_q and chunk_kv and q.shape[1] > 1:
        return _chunked_attention(q, k, v, q_positions=q_positions,
                                  kv_positions=kv_positions, causal=causal,
                                  window=window, softcap_val=softcap_val,
                                  chunk_q=chunk_q, chunk_kv=chunk_kv)
    s = _attn_scores(q, k, q.shape[-1] ** -0.5, softcap_val)
    mask = _attn_mask(q_positions, kv_positions, causal, window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).to(f32), v.to(f32))
    return o.to(q.dtype)


def _chunked_attention(q, k, v, *, q_positions, kv_positions, causal,
                       window, softcap_val, chunk_q, chunk_kv):
    """Online-softmax attention, O(chunk_q * chunk_kv) score memory (the
    reference's ``_chunked_attention``, its XLA path for long sequences;
    a plain yardstick here: the model's attention is ``ops.attention_op``,
    whose backward chunks over queries).  Ragged tails are padded (keys
    with position -1, so masked) and cut off again."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = hd ** -0.5
    cq, ckv = min(chunk_q, S), min(chunk_kv, T)
    nq, nkv = -(-S // cq), -(-T // ckv)
    qp = F.pad(q_positions, (0, nq * cq - S))
    kvp = F.pad(kv_positions, (0, nkv * ckv - T), value=-1)
    q_ = F.pad(q, (0, 0, 0, 0, 0, 0, 0, nq * cq - S))
    k_ = F.pad(k, (0, 0, 0, 0, 0, nkv * ckv - T))
    v_ = F.pad(v, (0, 0, 0, 0, 0, nkv * ckv - T))
    outs = []
    for i in range(nq):
        q_blk, qp_blk = q_[:, i * cq:(i + 1) * cq], qp[:, i * cq:(i + 1) * cq]
        acc = torch.zeros((B, K, G, cq, hd), dtype=f32, device=q.device)
        m = torch.full((B, K, G, cq), -math.inf, dtype=f32, device=q.device)
        l_sum = torch.zeros((B, K, G, cq), dtype=f32, device=q.device)
        for j in range(nkv):
            sl = slice(j * ckv, (j + 1) * ckv)
            s = _attn_scores(q_blk, k_[:, sl], scale, softcap_val)
            mask = _attn_mask(qp_blk, kvp[:, sl], causal, window)
            s = torch.where(mask[:, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l_sum = l_sum * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(v.dtype).to(f32),
                v_[:, sl].to(f32))
            m = m_new
        o = acc / torch.clamp_min(l_sum[..., None], 1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :S]


def _attn_mask(q_pos, kv_pos, causal, window):
    # (B, S, T) boolean validity
    qp = q_pos[:, :, None].to(torch.int32)
    kp = kv_pos[:, None, :].to(torch.int32)
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    return mask


def cache_write(cache, new, pos):
    """Write per-sequence entries into a cache at per-sequence positions,
    in place.

    cache: (B, S, ...); new: (B, ...); pos: (B,) int.  Returns ``cache``.
    Slots must lie in [0, S): a slot >= S raises IndexError where the
    reference clamps, and ``model.decode_step`` checks the positions once
    per step, so no out-of-range index reaches a CUDA tensor.

    On a DTensor cache (sharded on batch, and on its slot or head axis)
    each rank writes its own shard: ``new`` and ``pos`` are brought to
    the cache's placements (written out in ``_cache_write_local``).
    """
    if is_dtensor(cache):
        return _cache_write_local(cache, new, pos)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long()] = new.to(cache.dtype)
    return cache


def _cache_write_local(cache, new, pos):
    """``cache_write`` on the local shard of DTensor ``cache``: ``new``
    (one entry per sequence, the cache without its slot axis) takes the
    cache's placements with the slot axis dropped, ``pos`` its batch
    placements; a rank whose shard holds a slot axis range [lo, lo + n)
    writes the entries whose slot falls in it and rewrites the others'
    clamped slot with its own value (a select, no host sync)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    cp = tuple(cache.placements)
    new_p = tuple(Replicate() if p == Shard(1) else
                  (Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p)
                  for p in cp)
    pos_p = tuple(p if p == Shard(0) else Replicate() for p in cp)
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if not is_dtensor(pos):
        pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    loc = cache.to_local()
    new_l = new.to(cache.dtype).redistribute(mesh, new_p).to_local()
    pos_l = pos.redistribute(mesh, pos_p).to_local().long()
    lo, n = shard_offset(cache, 1)
    rows = torch.arange(loc.shape[0], device=loc.device)
    if lo == 0 and n == cache.shape[1]:
        loc[rows, pos_l] = new_l
        return cache
    slot = pos_l - lo
    mine = (slot >= 0) & (slot < n)
    slot = slot.clamp(0, n - 1)
    keep = mine.reshape((-1,) + (1,) * (new_l.ndim - 1))
    loc[rows, slot] = torch.where(keep, new_l, loc[rows, slot])
    return cache


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal temporal conv.

    x: (B, S, D); w: (W, D); b: (D,).  state: (B, W-1, D) history or None.
    Returns (y, new_state) where new_state holds the trailing W-1 inputs.
    """
    W = w.shape[0]
    if state is None:
        state = like(x, torch.zeros((x.shape[0], W - 1, x.shape[-1]),
                                    dtype=x.dtype, device=x.device))
    xp = torch.cat([state, x], dim=1)  # (B, S+W-1, D)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return (y + b).to(x.dtype), new_state


# --------------------------------------------------------------------------
# attention block (attn_global, attn_local, attn_bidir, attn_cross)
# --------------------------------------------------------------------------

def attn_template(cfg: ArchConfig):
    D, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    t = {
        "wq": ParamSpec((D, H * hd), ("embed", "heads")),
        "wk": ParamSpec((D, K * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((D, K * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, D), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((H * hd,), ("heads",), init="zeros")
        t["bk"] = ParamSpec((K * hd,), ("kv_heads",), init="zeros")
        t["bv"] = ParamSpec((K * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = ParamSpec((hd,), (None,), init="zeros")
        t["k_norm"] = ParamSpec((hd,), (None,), init="zeros")
    return t


def _project_q(p, cfg, x):
    """q (B, S, K, G, hd): the query projection alone, as cross attention
    needs (its k and v come from the encoder)."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = x.shape[1]
    q = dot(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if S > 1:
        q = constrain(q, "batch", None, "heads")
    q = split_last(q, K, H // K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_qkv(p, cfg, x):
    K, hd = cfg.n_kv_heads, cfg.head_dim
    S = x.shape[1]
    q = _project_q(p, cfg, x)
    k, v = dot(x, p["wk"]), dot(x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if S > 1:  # the reference's head-sharded attention layout
        k = constrain(k, "batch", None, "kv_heads")
        v = constrain(v, "batch", None, "kv_heads")
    k = split_last(k, K, hd)
    v = split_last(v, K, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_apply(p, cfg, x, positions, *, kind="attn_global", encoder_kv=None,
               make_cache=0):
    """Full-sequence attention from position 0.

    kind: attn_global | attn_local (window ``cfg.window_size``) |
    attn_bidir (the encoder's: no mask, no rope) | attn_cross (q from
    ``x``, k and v the encoder's, ``encoder_kv`` = (ek, ev) (B, T, K,
    hd); no mask).  Returns (y, cache|None); ``make_cache`` > 0 emits a
    decode cache of that many slots for attn_global and attn_local (a
    local cache holds at most ``cfg.window_size``).
    """
    S = x.shape[1]
    # the reference's chunk rule: above the threshold its attention runs
    # in query chunks; here those chunks bound the backward's scores
    chunk_q = cfg.attn_chunk_q if S > cfg.attn_chunk_threshold else 0
    if kind == "attn_cross":
        ek, ev = encoder_kv
        q = _project_q(p, cfg, x)
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
        # every (query, frame) pair is kept, so the kernel's positions
        # (indices from 0 on both sides) never matter: none are checked
        o = ops.attention_op(q, ek, ev, causal=False, chunk_q=chunk_q)
        return dot(merge_last(o, 3), p["wo"]), None
    q, k, v = _project_qkv(p, cfg, x)
    causal = kind != "attn_bidir"
    window = cfg.window_size if kind == "attn_local" else None
    if causal and cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ops.attention_op(q, k, v, causal=causal, window=window,
                         softcap=cfg.attn_softcap, positions=positions,
                         chunk_q=chunk_q)
    y = dot(merge_last(o, 3), p["wo"])

    cache = None
    if make_cache and kind in ("attn_global", "attn_local"):
        slots = make_cache if kind == "attn_global" else min(
            make_cache, cfg.window_size)
        n = min(S, slots)
        tail_pos = positions[:, S - n:].to(torch.int32)
        kt, vt = k[:, S - n:], v[:, S - n:]
        if kind == "attn_global" or n < slots:
            # the prefill starts at position 0, so the tail maps to slots
            # [0, n): a plain pad
            pad = slots - n
            cache = {}
            if cfg.kv_quant == "int8" and kind == "attn_global":
                (kt, ks), (vt, vs) = kv_quantize(kt), kv_quantize(vt)
                cache = {"k_scale": _pad_slots(ks, pad),
                         "v_scale": _pad_slots(vs, pad)}
            cache.update(k=_pad_slots(kt, pad), v=_pad_slots(vt, pad),
                         pos=_pad_slots(tail_pos, pad, -1))
        else:
            # full local ring buffer: slot = position % slots, which for
            # the last `slots` positions is a cyclic roll of the tail
            # (attention_op checked positions == 0..S-1, so the tail's first
            # position is S - n: no device read)
            shift = (S - n) % slots
            cache = {"k": _roll_slots(kt, shift),
                     "v": _roll_slots(vt, shift),
                     "pos": _roll_slots(tail_pos, shift)}
    return y, cache


def _pad_slots(t, pad, value=0):
    """``t`` (B, S, ...) with ``pad`` slots of ``value`` after its S (as
    ``F.pad``; a concatenation, which DTensor places in every torch
    version)."""
    if not pad:
        return t
    fill = torch.full((t.shape[0], pad) + tuple(t.shape[2:]), value,
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, like(t, fill)], dim=1)


def _roll_slots(t, shift):
    """``torch.roll(t, shift, dims=1)`` for 0 <= shift < t.shape[1], as
    two slices (DTensor has no sharding rule for roll in every torch
    version)."""
    if not shift:
        return t
    return torch.cat([t[:, -shift:], t[:, :-shift]], dim=1)


def kv_quantize(t):
    """Per (token, kv-head) symmetric int8: t (B, S, K, hd) -> (int8
    codes, fp32 scales (B, S, K)); rounds half to even, as jnp.round."""
    t32 = t.to(f32)
    scale = torch.clamp_min(t32.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _attn_decode_quant(q, cache, *, window, softcap_val, q_positions):
    """Decode attention over an int8 KV cache (the reference's XLA path,
    plain PyTorch on every device).  k's scale rescales each score
    column and v's scale rescales p before the PV product, so no
    dequantized copy of the cache is formed (the codes are widened to
    fp32 for the products).  q: (B, 1, K, G, hd)."""
    scale = q.shape[-1] ** -0.5
    kq, ks = cache["k"], cache["k_scale"]  # (B,T,K,hd) i8, (B,T,K) f32
    vq, vs = cache["v"], cache["v_scale"]
    s = torch.einsum("bskgd,btkd->bkgst", q.to(f32), kq.to(f32))
    s = s * ks.permute(0, 2, 1)[:, :, None, None, :] * scale
    s = softcap(s, softcap_val)
    mask = _attn_mask(q_positions, cache["pos"], True, window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p * vs.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bkgst,btkd->bskgd", p, vq.to(f32))
    return o.to(q.dtype)


def attn_decode(p, cfg, x, positions, cache, *, kind="attn_global",
                encoder_kv=None):
    """Single-token attention with a KV cache, updated in place.
    x: (B, 1, D); positions: (B,).  Returns (y, cache).

    Global caches are position-indexed (slot = position); local caches are
    ring buffers (slot = position % slots) with explicit slot positions.
    A cache with ``k_scale`` is int8 (``kv_quant="int8"``, global layers
    only): the new k and v are quantized into it and the step attends
    through ``_attn_decode_quant``, as in the reference; every other
    cache goes through the decode kernel.  attn_cross attends over the
    encoder's ``encoder_kv`` = (ek, ev) (B, T, K, hd) with no mask and
    leaves ``cache`` as it is.
    """
    B = x.shape[0]
    if kind == "attn_cross":
        ek, ev = encoder_kv
        q = _project_q(p, cfg, x)
        if cfg.use_rope:
            q = rope(q, positions[:, None], cfg.rope_theta)
        # the kernel keeps slot t where 0 <= kv_pos[t] <= q_pos: slot
        # positions of 0 keep every frame at every decode position (the
        # frames' own indices 0..T-1 would drop those past the position)
        kv_pos = positions.new_zeros((B, ek.shape[1]))
        o = ops.decode_attention_op(q, ek, ev, positions, kv_pos)
        return dot(merge_last(o, 3), p["wo"]), cache
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.use_rope:
        q = rope(q, positions[:, None], cfg.rope_theta)
        k = rope(k, positions[:, None], cfg.rope_theta)
    slots = cache["k"].shape[1]
    slot = positions % slots if kind == "attn_local" else positions
    window = cfg.window_size if kind == "attn_local" else None
    cache_write(cache["pos"], positions, slot)
    if "k_scale" in cache:  # int8 KV cache
        (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
        cache_write(cache["k"], kq[:, 0], slot)
        cache_write(cache["v"], vq[:, 0], slot)
        cache_write(cache["k_scale"], ks[:, 0], slot)
        cache_write(cache["v_scale"], vs[:, 0], slot)
        o = _attn_decode_quant(q, cache, window=window,
                               softcap_val=cfg.attn_softcap,
                               q_positions=positions[:, None])
        return dot(merge_last(o, 3), p["wo"]), cache
    cache_write(cache["k"], k[:, 0], slot)
    cache_write(cache["v"], v[:, 0], slot)
    o = ops.decode_attention_op(q, cache["k"], cache["v"], positions,
                                cache["pos"], window=window,
                                softcap=cfg.attn_softcap)
    return dot(merge_last(o, 3), p["wo"]), cache


# --------------------------------------------------------------------------
# gated MLP
# --------------------------------------------------------------------------

def mlp_template(cfg: ArchConfig):
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamSpec((D, 2 * Fd), ("embed", "ff")),  # fused gate+up
        "wo": ParamSpec((Fd, D), ("ff", "embed")),
    }


def mlp_apply(p, x):
    # the hidden pinned to ff (model) sharding, as the reference's
    gu = constrain(dot(x, p["wi"]), "batch", None, "ff")
    g, u = gu.chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    h = constrain(F.gelu(g.to(f32), approximate="tanh").to(x.dtype) * u,
                  "batch", None, "ff")
    return dot(h, p["wo"])


# --------------------------------------------------------------------------
# mixture of experts (granite-moe, olmoe)
# --------------------------------------------------------------------------

def moe_template(cfg: ArchConfig):
    D = cfg.d_model
    e = cfg.moe
    return {
        "router": ParamSpec((D, e.n_experts), ("embed", None)),
        "wi": ParamSpec((e.n_experts, D, 2 * e.d_expert_ff),
                        ("experts", "embed", "ff")),
        "wo": ParamSpec((e.n_experts, e.d_expert_ff, D),
                        ("experts", "ff", "embed")),
    }


def moe_route(p, cfg, xg):
    """The reference's routing of token groups xg (G, gs, D).

    Returns (probs, top_p, top_e, pos, cap, counts): probs (G, gs, E)
    fp32; top_p (G, gs, k), renormalized, and top_e (G, gs, k); pos
    (G, gs, k), each (token, slot)'s place in its expert's queue,
    counted in the group's (s, k)-flattened order; cap, the queue length
    (a slot with pos >= cap is dropped); counts (E,) int32, the slots
    routed to each expert over all groups, dropped ones included.

    The queue places come from an (G, E, gs*k) boolean, not from the
    reference's (G, gs, k, E, C) one-hot, scanned as one flat cumsum
    (a 1-D scan runs in parallel on the card, where a scan along a
    16384-long middle axis of 32 columns runs serially), from which
    each (group, expert) row subtracts its own start.
    """
    e = cfg.moe
    G, gs, _ = xg.shape
    E, k = e.n_experts, e.top_k
    logits = torch.matmul(xg.to(f32), p["router"].to(f32))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    cap = max(int(e.capacity_factor * gs * k / E), 1)
    flat = merge_last(top_e, 2)[:, None]  # (G, 1, gs*k)
    experts = like(flat, torch.arange(E, device=xg.device)[:, None])
    onehot = (flat == experts).to(torch.int32)  # (G, E, gs*k)
    before = merge_last(onehot, 3).cumsum(0, dtype=torch.int32).view(
        onehot.shape) - onehot  # exclusive, over all rows so far
    before = before - before[..., :1]  # from each row's own start
    pos = before.gather(1, flat).reshape(G, gs, k)
    counts = onehot.sum((0, 2), dtype=torch.int32)
    return probs, top_p, top_e, pos, cap, counts


def _dot_f32(a, b):
    """Batched a @ b with an fp32 result (the reference's
    preferred_element_type=f32): fp32 accumulation of bf16 products,
    not rounded back to bf16."""
    if a.dtype == f32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=f32)
    return torch.matmul(a.to(f32), b.to(f32))


def _scatter_rows(rows, slot, n):
    """An (n, D) buffer of zeros with ``rows`` written at ``slot``
    (``buf[slot] = rows``).  On DTensors each rank writes the whole
    buffer from the rows and slots gathered whole, and it comes back
    replicated, as the reference's one-hot dispatch is until its
    constraint (DTensor has no rule for ``index_put_`` on some torch
    versions)."""
    if is_dtensor(rows):
        return like(rows, _scatter_rows(rows.full_tensor(),
                                        slot.full_tensor(), n))
    buf = rows.new_zeros((n, rows.shape[-1]))
    buf[slot] = rows
    return buf


def moe_apply(p, cfg, x, group_size=None):
    """Switch-style capacity-routed MoE (the reference's grouped one-hot
    dispatch), computed from indices.

    x: (B, S, D).  Returns (y, aux): aux carries the router load (the
    per-expert share of the routed (token, slot) pairs, dropped ones
    included: the Level-B utilization signal) and the load-balancing
    loss.  Kept rows are gathered into an (E, G*C, D) buffer (zeros in
    empty slots), both expert products run batched over E, and each
    token sums its kept slots' outputs weighted by top_p in fp32.  The
    gather equals the reference's one-hot dispatch exactly (a one-hot
    sum has one term); only the combine's summation order differs.
    """
    e = cfg.moe
    B, S, D = x.shape
    N, E, k = B * S, e.n_experts, e.top_k
    gs = min(group_size or cfg.moe_group, N)
    G = N // gs
    x = flat_rows(x)
    xg = x.reshape(G, gs, D)
    probs, top_p, top_e, pos, cap, counts = moe_route(p, cfg, xg)

    # flat (e, g, c) slot of each (token, k); dropped ones go to a spare
    # row past the E*G*C buffer
    grp = like(x, torch.arange(G, device=x.device)[:, None, None])
    keep = pos < cap
    slot = torch.where(keep, (top_e * G + grp) * cap + pos, E * G * cap)
    slot = slot.reshape(N * k)
    tok = like(x, torch.arange(N * k, device=x.device) // k)
    buf = _scatter_rows(x.reshape(N, D)[tok], slot, E * G * cap + 1)
    # the dispatched rows: experts over the EP axis, token groups over DP
    # (the reference's constraint on its one-hot dispatch's output)
    xin = constrain(buf[:-1].view(E, G, cap, D), "experts", "batch", None,
                    "embed").reshape(E, G * cap, D)

    gu = torch.matmul(xin, p["wi"])  # x.dtype, fp32 accumulation
    g, u = gu.chunk(2, dim=-1)
    h = F.gelu(g.to(f32), approximate="tanh").to(x.dtype) * u
    hout = _dot_f32(h, p["wo"])

    w = (top_p * keep).reshape(N, k, 1)  # 0 for a dropped slot
    # on DTensors each rank gathers the rows of its experts' shard and the
    # partial sums are reduced (``lookup``)
    rows = lookup(hout.view(E * G * cap, D),
                  slot.clamp_max(E * G * cap - 1)).view(N, k, D)
    y = (rows * w).sum(1).to(x.dtype)

    load = counts.to(f32) / (N * k)
    importance = probs.mean((0, 1))
    aux = {"expert_load": load,
           "moe_aux_loss": E * torch.sum(load * importance)}
    return y.reshape(B, S, D), aux


# --------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma / Griffin)
# --------------------------------------------------------------------------

def rglru_template(cfg: ArchConfig):
    D = cfg.d_model
    R = cfg.rglru_dim or D
    W = cfg.conv_width
    return {
        "wx": ParamSpec((D, R), ("embed", "ff")),  # recurrence branch in
        "wg": ParamSpec((D, R), ("embed", "ff")),  # gate branch in
        "wo": ParamSpec((R, D), ("ff", "embed")),
        "conv_w": ParamSpec((W, R), (None, "ff"), scale=1.0 / W),
        "conv_b": ParamSpec((R,), ("ff",), init="zeros"),
        "lam": ParamSpec((R,), ("ff",), init="ones"),  # decay logits
        "w_a": ParamSpec((R, R), ("ff", None)),  # recurrence gate r_t
        "w_i": ParamSpec((R, R), ("ff", None)),  # input gate i_t
    }


_RGLRU_C = 8.0  # Griffin's fixed decay temperature


def _rglru_coeffs(p, u):
    """Gates and log-decay for RG-LRU.  u: (B, S, R) post-conv input.
    Returns (a, gated), both fp32."""
    u32 = flat_rows(u.to(f32))
    r = torch.sigmoid(rows_out(torch.matmul(u32, p["w_a"].to(f32))))
    i = torch.sigmoid(rows_out(torch.matmul(u32, p["w_i"].to(f32))))
    lam = p["lam"].to(f32)
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus turns linear
    # above a threshold)
    log_a = -_RGLRU_C * r * torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * i * u32
    return a, gated


def rglru_apply(p, cfg, x, *, make_cache=False):
    """Full-sequence RG-LRU block; the recurrence runs in ``ops.rglru_op``
    (the kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    u = dot(x, p["wx"])
    gate = F.gelu(dot(x, p["wg"]).to(f32), approximate="tanh").to(x.dtype)
    u, conv_state = causal_conv1d(u, p["conv_w"], p["conv_b"])
    a, gated = _rglru_coeffs(p, u)
    h = ops.rglru_op(a, gated)
    y = dot(h.to(x.dtype) * gate, p["wo"])
    cache = None
    if make_cache:
        cache = {"h": h[:, -1].to(f32), "conv": conv_state}
    return y, cache


def rglru_decode(p, cfg, x, cache):
    """One-step RG-LRU.  x: (B, 1, D); cache: {"h": (B,R) f32, "conv"}.
    Returns (y, new state): the state is replaced, not updated in place."""
    u = dot(x, p["wx"])
    gate = F.gelu(dot(x, p["wg"]).to(f32), approximate="tanh").to(x.dtype)
    u, conv_state = causal_conv1d(u, p["conv_w"], p["conv_b"],
                                  state=cache["conv"])
    a, gated = _rglru_coeffs(p, u)
    h = cache["h"] * a[:, 0] + gated[:, 0]  # (B, R)
    y = dot(h[:, None].to(x.dtype) * gate, p["wo"])
    return y, {"h": h, "conv": conv_state}


# --------------------------------------------------------------------------
# xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
# --------------------------------------------------------------------------

_MLSTM_STATE = ("C", "n", "m")
_SLSTM_STATE = ("c", "n", "h", "m")
_SLSTM_GATES = ("i", "f", "z", "o")


def _xlstm_heads(cfg: ArchConfig) -> tuple[int, int]:
    """(heads, head width) of an mLSTM / sLSTM block."""
    nh = cfg.lru_heads or cfg.n_heads
    return nh, cfg.d_model // nh


def mlstm_template(cfg: ArchConfig):
    D = cfg.d_model
    nh, _ = _xlstm_heads(cfg)
    return {
        "wq": ParamSpec((D, D), ("embed", "heads")),
        "wk": ParamSpec((D, D), ("embed", "heads")),
        "wv": ParamSpec((D, D), ("embed", "heads")),
        "wi": ParamSpec((D, nh), ("embed", None), scale=0.1),
        "wf": ParamSpec((D, nh), ("embed", None), scale=0.1),
        "bf": ParamSpec((nh,), (None,), init="ones"),
        "wg": ParamSpec((D, D), ("embed", "heads")),  # output gate branch
        "wo": ParamSpec((D, D), ("heads", "embed")),
    }


def _step_inputs(a):
    """An xLSTM step's inputs (B, S, heads, ...) as the step reads them:
    on a DTensor with no time axis or head axis sharded (the loop reads
    one time step a step; the per-head products run batch-sharded
    only)."""
    return gather_dim(gather_dim(a, 1), 2)


def _step_outputs(hs):
    """The loop's stacked outputs (B, S, heads, ...), whose gradient on a
    DTensor is gathered as ``_step_inputs`` gathers the inputs, so each
    step's backward runs batch-sharded only, as its forward does (a
    gradient split over heads reaches the step's products, whose
    backward flattens batch and heads: some torch versions refuse that
    flatten of a sharded dim)."""
    if not is_dtensor(hs):
        return hs
    return _StepOutputsGrad.apply(hs)


class _StepOutputsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hs):
        return hs.view_as(hs)

    @staticmethod
    def backward(ctx, g):
        return _step_inputs(g)


def _mlstm_gates(p, x):
    """Input-gate and forget-gate logs (B, S, nh), fp32."""
    x32 = flat_rows(x.to(f32))
    i_log = rows_out(torch.matmul(x32, p["wi"].to(f32)))
    f_log = log_sigmoid(rows_out(torch.matmul(x32, p["wf"].to(f32)))
                        + p["bf"].to(f32))
    return i_log, f_log


def _mlstm_proj(p, cfg, x):
    """q, k, v and the output gate (B, S, nh, dh) fp32, and the gate
    logs (B, S, nh)."""
    nh, dh = _xlstm_heads(cfg)
    q = split_last(dot(x, p["wq"]), nh, dh).to(f32) * dh ** -0.5
    k = split_last(dot(x, p["wk"]), nh, dh).to(f32) * dh ** -0.5
    v = split_last(dot(x, p["wv"]), nh, dh).to(f32)
    og = split_last(torch.sigmoid(dot(x, p["wg"]).to(f32)), nh, dh)
    return (q, k, v, og) + _mlstm_gates(p, x)


def _mlstm_step(state, q, k, v, og, il, fl):
    """One stabilized mLSTM step: state (C (B,nh,dh,dh), n (B,nh,dh),
    m (B,nh)); returns (new state, h (B, nh, dh))."""
    C, n, m = state
    m_new = torch.maximum(fl + m, il)
    i_ = torch.exp(il - m_new)
    f_ = torch.exp(fl + m - m_new)
    C = f_[..., None, None] * C + i_[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_[..., None] * n + i_[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.maximum(torch.einsum("bhj,bhj->bh", n, q).abs(),
                        torch.exp(-m_new))[..., None]
    return (C, n, m_new), og * (num / den)


def mlstm_apply(p, cfg, x, *, make_cache=False):
    """Stabilized mLSTM, a sequential loop over time (fp32 state).

    State per head: C (dh, dh) matrix memory, n (dh,) normalizer, m scalar
    stabilizer.  h_t = o_t * (C_t q_t / max(|n_t.q_t|, exp(-m_t))).
    """
    B, S, _ = x.shape
    nh, dh = _xlstm_heads(cfg)
    proj = tuple(_step_inputs(a) for a in _mlstm_proj(p, cfg, x))
    state = tuple(like(x, torch.zeros(shape, dtype=f32, device=x.device))
                  for shape in ((B, nh, dh, dh), (B, nh, dh), (B, nh)))
    state, hs = time_loop(
        lambda st, t: _mlstm_step(st, *(a[:, t] for a in proj)), state, S)
    h = merge_last(_step_outputs(hs), 2).to(x.dtype)
    cache = dict(zip(_MLSTM_STATE, state)) if make_cache else None
    return dot(h, p["wo"]), cache


def mlstm_decode(p, cfg, x, cache):
    """One mLSTM step.  x: (B, 1, D).  Returns (y, new state): the state
    is replaced, not updated in place."""
    state, h = _mlstm_step(tuple(cache[k] for k in _MLSTM_STATE),
                           *(_step_inputs(a)[:, 0]
                             for a in _mlstm_proj(p, cfg, x)))
    y = dot(merge_last(h, 2)[:, None].to(x.dtype), p["wo"])
    return y, dict(zip(_MLSTM_STATE, state))


def slstm_template(cfg: ArchConfig):
    D = cfg.d_model
    nh, dh = _xlstm_heads(cfg)
    t = {}
    for g in _SLSTM_GATES:
        t[f"w{g}"] = ParamSpec((D, D), ("embed", "heads"))
        t[f"r{g}"] = ParamSpec((nh, dh, dh), (None, None, None), scale=0.1)
        t[f"b{g}"] = ParamSpec((D,), ("heads",), init="zeros")
    t["wo_out"] = ParamSpec((D, D), ("heads", "embed"))
    return t


def _slstm_pre(p, cfg, x):
    """The four gates' input parts (B, S, nh, dh) fp32 and their
    block-diagonal recurrent weights stacked by gate (nh, 4*dh, dh)."""
    nh, dh = _xlstm_heads(cfg)
    pre = [split_last((dot(x, p[f"w{g}"]) + p[f"b{g}"]).to(f32), nh, dh)
           for g in _SLSTM_GATES]
    R = torch.cat([p[f"r{g}"].to(f32) for g in _SLSTM_GATES], dim=1)
    return pre, R


def _slstm_step(state, R, xi, xf, xz, xo):
    """One stabilized sLSTM step: state (c, n, h, m), each (B, nh, dh)
    (m: a per-unit stabilizer); returns the new state."""
    c, n, h, m = state
    ri, rf, rz, ro = torch.einsum("bhj,hij->bhi", h, R).chunk(4, dim=-1)
    il = xi + ri
    fl = log_sigmoid(xf + rf)
    m_new = torch.maximum(fl + m, il)
    i_ = torch.exp(il - m_new)
    f_ = torch.exp(fl + m - m_new)
    z = torch.tanh(xz + rz)
    o = torch.sigmoid(xo + ro)
    c = f_ * c + i_ * z
    n = torch.maximum(f_ * n + i_, torch.exp(-m_new))
    return c, n, o * c / n, m_new


def slstm_apply(p, cfg, x, *, make_cache=False):
    """Stabilized sLSTM with block-diagonal recurrence, a sequential loop
    over time (fp32 state)."""
    B, S, _ = x.shape
    nh, dh = _xlstm_heads(cfg)
    pre, R = _slstm_pre(p, cfg, x)
    pre = [_step_inputs(a) for a in pre]
    zeros = like(x, torch.zeros((B, nh, dh), dtype=f32, device=x.device))
    state = (zeros, zeros + 1e-6, zeros, zeros)
    def step(st, t):
        st = _slstm_step(st, R, *(a[:, t] for a in pre))
        return st, st[2]
    state, hs = time_loop(step, state, S)
    h = merge_last(_step_outputs(hs), 2).to(x.dtype)
    cache = dict(zip(_SLSTM_STATE, state)) if make_cache else None
    return dot(h, p["wo_out"]), cache


def slstm_decode(p, cfg, x, cache):
    """One sLSTM step.  x: (B, 1, D).  Returns (y, new state)."""
    pre, R = _slstm_pre(p, cfg, x)
    state = _slstm_step(tuple(cache[k] for k in _SLSTM_STATE), R,
                        *(_step_inputs(a)[:, 0] for a in pre))
    y = dot(merge_last(state[2], 2)[:, None].to(x.dtype), p["wo_out"])
    return y, dict(zip(_SLSTM_STATE, state))
