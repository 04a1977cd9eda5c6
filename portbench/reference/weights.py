"""The weights of a served function, drawn again from its seed.

A frozen copy of the port's weight draw (``init_params`` with
``blank_experts`` and the engine's per-expert builder), for the
decoders the benchmark serves: every layer ``attn_global``, a gated MLP
or a routed MoE layer, no biases, no frontends.  The draw runs on the
device the program used, in the dtype it serves, leaf by leaf in the
program's order, so the same seed gives the same bits; the reference
then computes with them in float32.  It reads only the configuration
file's numbers, never the program.
"""

from __future__ import annotations

import math
import zlib

import torch


def _leaf(shape, init="normal", scale=None):
    return {"shape": tuple(shape), "init": init, "scale": scale}


def _std(shape, scale):
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    return scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))


def template(cfg: dict) -> dict:
    """The parameter tree's leaves, in the order the program draws them.
    Layer leaves are stacked over ``n_layers`` (leading axis)."""
    D, V, H, K, hd = (cfg["d_model"], cfg["vocab"], cfg["n_heads"],
                      cfg["n_kv_heads"], cfg["head_dim"])
    t = {"embed": _leaf((V, D), scale=1.0),
         "final_norm": _leaf((D,), "zeros")}
    if not cfg["tie_embeddings"]:
        t["lm_head"] = _leaf((D, V))
    attn = {"wq": _leaf((D, H * hd)), "wk": _leaf((D, K * hd)),
            "wv": _leaf((D, K * hd)), "wo": _leaf((H * hd, D))}
    if cfg["qk_norm"]:
        attn["q_norm"] = _leaf((hd,), "zeros")
        attn["k_norm"] = _leaf((hd,), "zeros")
    block = {"ln1": _leaf((D,), "zeros"), "attn": attn,
             "ln2": _leaf((D,), "zeros")}
    moe = cfg.get("moe")
    if moe:
        E, F = moe["n_experts"], moe["d_expert_ff"]
        block["moe"] = {"router": _leaf((D, E)),
                        "wi": _leaf((E, D, 2 * F)), "wo": _leaf((E, F, D))}
    else:
        F = cfg["d_ff"]
        block["mlp"] = {"wi": _leaf((D, 2 * F)), "wo": _leaf((F, D))}
    t["layers"] = {"scan": {"pos0": block}}
    return t


def draw(cfg: dict, seed: int, device) -> dict:
    """The parameter tree of the function whose weight seed is ``seed``:
    the core from one generator seeded with ``seed``, each expert's
    slice of every MoE layer from its own generator keyed by crc32 of
    (seed, expert, layer path, leaf)."""
    dtype = getattr(torch, cfg["dtype"])
    n_layers = cfg["n_layers"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(tmpl, stacked, path):
        out = {}
        for k, s in tmpl.items():
            if "shape" not in s:
                out[k] = build(s, stacked or f"{path}{k}" == "layers",
                               f"{path}{k}/")
                continue
            shape = ((n_layers,) if stacked else ()) + s["shape"]
            t = torch.empty(shape, dtype=dtype, device=device)
            if s["init"] == "zeros" or (path.endswith("moe/")
                                         and k in ("wi", "wo")):
                t.zero_()  # experts come from their own generators
            elif stacked:
                std = _std(s["shape"], s["scale"])
                for i in range(n_layers):
                    t[i].normal_(0.0, std, generator=gen)
            else:
                t.normal_(0.0, _std(s["shape"], s["scale"]), generator=gen)
            out[k] = t
        return out

    params = build(template(cfg), False, "")
    if cfg.get("moe"):
        moe = params["layers"]["scan"]["pos0"]["moe"]
        for e in range(cfg["moe"]["n_experts"]):
            for w in ("wi", "wo"):
                key = zlib.crc32(f"{seed}/{e}//scan/pos0/{w}".encode())
                g = torch.Generator(device=device)
                g.manual_seed(key)
                leaf = moe[w]  # (n_layers, E, fan_in, out)
                leaf[:, e].normal_(0.0, leaf.shape[2] ** -0.5, generator=g)
    return params
