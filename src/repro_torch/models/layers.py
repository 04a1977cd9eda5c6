"""Building blocks of the dense decoder (PyTorch port of
``repro.models.layers``, dense ``attn_global`` subset).

Each block keeps the reference's three parts: ``*_template(cfg)`` (a
flat dict ``name -> ParamSpec``), ``*_apply`` (full sequence) and
``*_decode`` (one token with a KV cache).  Parameter names, shapes and
the ``(in, out)`` matrix layout are the reference's, so a parameter
tree converts with no transposes (``repro_torch.models.convert``).

Attention goes through ``repro_torch.kernels.ops``: on a CUDA tensor
that launches the hand-written kernels, on a CPU tensor it runs their
plain PyTorch versions.  ``attention`` below is the reference's einsum
path in model layout, kept as the plain yardstick the tests hold the
kernel wrappers against.

Numerics policy (as the reference): parameters and activations are
``cfg.tdtype``; matmuls accumulate in fp32 (cuBLAS and the CPU GEMMs do
so for bf16 inputs); norms, softmax and rope run in fp32 and cast back.
Unlike the reference, which clamps out-of-range cache slots
(``lax.dynamic_update_slice``), the port raises on them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

f32 = torch.float32
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axes, len == ndim
    init: str = "normal"  # "normal" | "zeros"
    scale: Optional[float] = None  # None => 1/sqrt(fan_in)

    def std(self) -> float:
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return self.scale if self.scale is not None else \
            1.0 / math.sqrt(max(fan_in, 1))

    def fill_(self, out: torch.Tensor, generator: torch.Generator):
        """Initialize ``out`` (of this spec's shape) in place."""
        if self.init == "zeros":
            return out.zero_()
        return out.normal_(0.0, self.std(), generator=generator)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def dot(x, w):
    """Matmul with fp32 accumulation, output in x.dtype."""
    return torch.matmul(x, w)


def rms_norm(x, scale, eps):
    x32 = x.to(f32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(f32))).to(x.dtype)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x, positions, theta):
    """Rotary embedding, half-rotation convention (llama/gemma).

    x: (B, S, ..., head_dim) with any number of middle (head) dims;
    positions: (B, S) absolute positions.
    """
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=f32, device=x.device)
                     / half)
    ang = positions[..., None].to(f32) * freq  # (B, S, half)
    extra = x.ndim - positions.ndim - 1  # head dims to broadcast over
    ang = ang.reshape(ang.shape[:-1] + (1,) * extra + (half,))
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, q_positions, kv_positions, causal=True,
              window=None, softcap_val=None):
    """Masked multi-query attention (GQA layout), the reference's
    unchunked einsum path.

    q: (B, S, K, G, hd); k, v: (B, T, K, hd).
    q_positions: (B, S) absolute positions of queries.
    kv_positions: (B, T) absolute positions of keys (-1 = invalid slot).
    window: if set, keys with q_pos - k_pos >= window are masked (local).
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgd,btkd->bkgst", q.to(f32), k.to(f32))
    s = softcap(s * scale, softcap_val)
    mask = _attn_mask(q_positions, kv_positions, causal, window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).to(f32), v.to(f32))
    return o.to(q.dtype)


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
    """
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long()] = new.to(cache.dtype)
    return cache


# --------------------------------------------------------------------------
# attention block (dense, attn_global)
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
    return t


def _project_qkv(p, cfg, x):
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S, _ = x.shape
    q, k, v = dot(x, p["wq"]), dot(x, p["wk"]), dot(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, K, H // K, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    return q, k, v


def attn_apply(p, cfg, x, positions, *, make_cache=0):
    """Full-sequence causal attention from position 0.

    Returns (y, cache|None); ``make_cache`` > 0 emits a decode cache of
    that many slots (position-indexed: the prefill fills slots [0, S)).
    """
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ops.attention_op(q, k, v, causal=True, softcap=cfg.attn_softcap,
                         positions=positions)
    y = dot(o.reshape(B, S, H * hd), p["wo"])

    cache = None
    if make_cache:
        n = min(S, make_cache)
        pad = make_cache - n
        cache = {
            "k": F.pad(k[:, S - n:], (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v[:, S - n:], (0, 0, 0, 0, 0, pad)),
            "pos": F.pad(positions[:, S - n:].to(torch.int32), (0, pad),
                         value=-1),
        }
    return y, cache


def attn_decode(p, cfg, x, positions, cache):
    """Single-token attention with a position-indexed KV cache, updated
    in place.  x: (B, 1, D); positions: (B,).  Returns (y, cache)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x)
    if cfg.use_rope:
        q = rope(q, positions[:, None], cfg.rope_theta)
        k = rope(k, positions[:, None], cfg.rope_theta)
    cache_write(cache["k"], k[:, 0], positions)
    cache_write(cache["v"], v[:, 0], positions)
    cache_write(cache["pos"], positions, positions)
    o = ops.decode_attention_op(q, cache["k"], cache["v"], positions,
                                cache["pos"], softcap=cfg.attn_softcap)
    return dot(o.reshape(B, 1, H * hd), p["wo"]), cache


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
    gu = dot(x, p["wi"])
    g, u = gu.chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(g.to(f32), approximate="tanh").to(x.dtype) * u
    return dot(h, p["wo"])
