"""The plain float32 reference of the served decoders.

Every layer is causal global attention (grouped-query, rotary
positions, optional QK-norm) followed by a gated MLP or a routed MoE
layer, as the configuration file states them; the logits come from the
tied embedding or the head.  Weights are the program's bf16 values
(``weights.draw``), widened to float32 one layer at a time; activations
stay float32; TF32 is off while it runs.  No kernel, no cache, no batch
of the program's is used: one forward over the prompt and the tokens the
program served.

The MoE layer is capacity-routed as the configuration states
(``capacity_factor``, ``moe_group``): the tokens the program routed
together compete for the same expert slots.  A prefill routes the
prompt's ``B * S`` tokens (row-major) in groups of ``moe_group``; each
decode step routes the batch's ``B`` new tokens as one group.  So the
forward takes ``prefill_len`` and routes positions past it one position
at a time across the batch.

``fp8=True`` is the control: every matmul's two operands rounded to
float8 e4m3 (per-column scales on weights, per-row on activations) and
multiplied in float32, the precision a later change might be tempted to
serve in.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

f32 = torch.float32
NEG = -1e30


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t, dim):
    """``t`` rounded to float8 e4m3 with an absmax scale along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(f32) * scale


def _mm(x, w, fp8):
    """x (..., n) @ w (n, m) in float32."""
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, pos, theta):
    """x (B, L, heads, hd), pos (L,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=f32, device=x.device) / half)
    ang = pos.to(f32)[:, None] * freq  # (L, half)
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block=512):
    """Causal attention; q (B, L, H, hd), k, v (B, L, K, hd)."""
    B, L, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)  # (B, H, L, hd)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    kpos = torch.arange(L, device=q.device)
    for a in range(0, L, block):
        b = min(a + block, L)
        s = (q[:, :, a:b] @ k[:, :, :b].transpose(-1, -2)) * hd ** -0.5
        mask = kpos[None, :b] <= torch.arange(a, b, device=q.device)[:, None]
        s = torch.where(mask, s, NEG)
        out[:, :, a:b] = torch.softmax(s, dim=-1) @ v[:, :, :b]
    return out.transpose(1, 2)


def _gelu_mlp(h, wi, wo, fp8):
    g, u = _mm(h, wi, fp8).chunk(2, dim=-1)
    return _mm(F.gelu(g, approximate="tanh") * u, wo, fp8)


def _route_groups(B, L, prefill_len, group):
    """Token groups (flat row-major indices into (B, L)) in the order the
    program routes them: the prompt's tokens in groups of ``group``,
    then one group of the batch per decode position."""
    idx = torch.arange(B * L).view(B, L)
    pre = idx[:, :prefill_len].reshape(-1)
    gs = min(group, pre.numel())
    groups = list(pre[:pre.numel() // gs * gs].view(-1, gs))
    groups += [idx[:, t] for t in range(prefill_len, L)]
    return groups


def _moe(h, p, moe, groups, fp8):
    """The routed MoE layer on h (N, D) over the given token groups."""
    E, k = moe["n_experts"], moe["top_k"]
    logits = _mm(h, p["router"], fp8)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.zeros_like(top_p, dtype=torch.bool)
    for g in groups:
        g = g.to(h.device)
        cap = max(int(moe["capacity_factor"] * len(g) * k / E), 1)
        flat = top_e[g].reshape(-1)  # queue order: token, then slot
        onehot = F.one_hot(flat, E)
        place = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
        keep[g] = (place < cap).view(len(g), k)
    w = top_p * keep
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _gelu_mlp(h[tok], p["wi"][e].to(f32), p["wo"][e].to(f32), fp8)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def logits(cfg: dict, params: dict, tokens, positions, *, prefill_len,
           fp8=False):
    """float32 logits (B, len(positions), V) at ``positions`` of the
    forward over ``tokens`` (B, L), whose first ``prefill_len`` positions
    the program prefilled together (the rest it decoded one at a
    time)."""
    B, L = tokens.shape
    dev = tokens.device
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    lay = params["layers"]["scan"]["pos0"]
    pos = torch.arange(L, device=dev)
    groups = (_route_groups(B, L, prefill_len, cfg["moe_group"])
              if cfg.get("moe") else None)
    with no_tf32(), torch.no_grad():
        x = params["embed"][tokens].to(f32)
        for i in range(cfg["n_layers"]):
            # the experts stay in their dtype: each is widened when used
            p = {k: (v[i].to(f32) if not isinstance(v, dict) else
                     {kk: vv[i] if k == "moe" and kk != "router"
                      else vv[i].to(f32) for kk, vv in v.items()})
                 for k, v in lay.items()}
            a = p["attn"]
            h = _rms(x, p["ln1"], eps)
            q = _mm(h, a["wq"], fp8).view(B, L, H, hd)
            kk = _mm(h, a["wk"], fp8).view(B, L, K, hd)
            vv = _mm(h, a["wv"], fp8).view(B, L, K, hd)
            if cfg["qk_norm"]:
                q, kk = _rms(q, a["q_norm"], eps), _rms(kk, a["k_norm"], eps)
            q, kk = _rope(q, pos, theta), _rope(kk, pos, theta)
            o = _attention(q, kk, vv).reshape(B, L, H * hd)
            x = x + _mm(o, a["wo"], fp8)
            h = _rms(x, p["ln2"], eps)
            if "moe" in p:
                y = _moe(h.reshape(B * L, -1), p["moe"], cfg["moe"], groups,
                         fp8).view(B, L, -1)
            else:
                y = _gelu_mlp(h, p["mlp"]["wi"], p["mlp"]["wo"], fp8)
            x = x + y
        x = _rms(x[:, positions], params["final_norm"].to(f32), eps)
        w = (params["embed"].T if cfg["tie_embeddings"]
             else params["lm_head"])
        return _mm(x, w.to(f32), fp8)
