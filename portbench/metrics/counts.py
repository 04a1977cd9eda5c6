"""Operations and bytes of the work a window served, from its shapes.

Counted from the traffic's own sizes and the configuration file, so
they read the same work whatever implements it.  A matmul of an (m, n)
by (n, p) counts 2mnp operations; attention counts 4 hd operations per
(query, key) pair and head (QK^T and PV); causal prefill attends to
S(S+1)/2 pairs per head and row, a decode step at position p to the
p + 1 filled slots.  Bytes count each input once and each output once,
in the served dtype (2 bytes).

These counts are of the decoders ``reference/model.py`` computes: GQA
attention over ``n_kv_heads`` x ``head_dim`` and a gated MLP or top-k
experts.  A configuration whose file names its own reference module
(``"reference": "<stem>"``, see ``reference/__init__.py``) is counted
by that module's ``body_params``, ``attn_flops``, ``flash_call`` and
``decode_call`` where it defines them, and by these where it does not;
``served_flops`` and ``kernel_work`` call through, so they count any
architecture whose module states its own work.
"""

from __future__ import annotations

import functools

from portbench import reference

# one NVIDIA H100 SXM (data sheet, dense, no sparsity), at a 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = 2


def per_config(fn):
    """``fn``, or the function of the same name that the configuration's
    own reference module defines (``own(cfg, name)``)."""
    @functools.wraps(fn)
    def call(cfg, *args):
        return (own(cfg, fn.__name__) or fn)(cfg, *args)
    return call


def own(cfg: dict, name: str):
    """The configuration's reference module's count ``name``, or None."""
    return getattr(reference.module(cfg), name, None)


@per_config
def body_params(cfg: dict) -> int:
    """Matmul parameters a token passes through below the head: the
    attention projections and the MLP, or the router and its top-k
    experts."""
    D, H, K, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    attn = D * hd * (H + 2 * K) + H * hd * D
    moe = cfg.get("moe")
    if moe:
        ff = D * moe["n_experts"] + moe["top_k"] * 3 * D * moe["d_expert_ff"]
    else:
        ff = 3 * D * cfg["d_ff"]
    return cfg["n_layers"] * (attn + ff)


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab"]


def attn_pairs_causal(S: int) -> int:
    return S * (S + 1) // 2


@per_config
def attn_flops(cfg: dict, B: int, pairs: int) -> int:
    """All layers' attention operations over ``pairs`` (query, key)
    pairs per head and row."""
    return 4 * cfg["head_dim"] * cfg["n_heads"] * B * pairs * cfg["n_layers"]


def served_flops(cfg: dict, B: int, entry: str, S: int, new: int) -> int:
    """Model operations of one invocation: ``generate`` prefills S tokens
    (the head on the last) and decodes new - 1 steps; ``score`` runs the
    forward and the head over all S."""
    body, head = body_params(cfg), head_params(cfg)
    f = 2 * body * B * S + attn_flops(cfg, B, attn_pairs_causal(S))
    if entry == "score":
        return f + 2 * head * B * S
    f += 2 * head * B
    for j in range(new - 1):
        f += 2 * (body + head) * B + attn_flops(cfg, B, S + j + 1)
    return f


# ------------------------------------------------------------- kernels
@per_config
def flash_call(cfg: dict, B: int, S: int) -> tuple[int, int]:
    """(operations, bytes) of one causal prefill attention call, one
    layer: q and o of H heads, k and v of K heads, S rows each."""
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flops = 4 * hd * H * B * attn_pairs_causal(S)
    nbytes = DTYPE_BYTES * B * S * hd * (2 * H + 2 * K)
    return flops, nbytes


@per_config
def decode_call(cfg: dict, B: int, filled: int) -> tuple[int, int]:
    """(operations, bytes) of one decode attention call, one layer, over
    ``filled`` cache slots a row: q and o of H heads, k and v of the
    filled slots of K heads."""
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flops = 4 * hd * H * B * filled
    nbytes = DTYPE_BYTES * B * hd * (2 * H + 2 * K * filled)
    return flops, nbytes


def least_s(flops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def kernel_work(cfg: dict, B: int, records, prefill_len: int):
    """(flash least seconds, flash calls, decode least seconds, decode
    calls) of every attention call the window's invocations made: their
    prefills and decode steps, and the warm-up each compile component
    built in the window ran (``compile.generate``: a prefill at
    ``prefill_len`` and one graph warm-up step at position 0 over one
    slot; ``compile.score``: a forward at ``prefill_len``)."""
    L = cfg["n_layers"]
    fl_s = dec_s = 0.0
    fl_n = dec_n = 0

    def flash(S):
        nonlocal fl_s, fl_n
        fl_s += L * least_s(*flash_call(cfg, B, S))
        fl_n += L

    def decode(filled):
        nonlocal dec_s, dec_n
        dec_s += L * least_s(*decode_call(cfg, B, filled))
        dec_n += L

    for r in records:
        for comp in r.get("built", ()):
            if comp in ("compile.generate", "compile.score"):
                flash(prefill_len)
            if comp == "compile.generate":
                decode(1)
        if not r["ok"]:
            continue
        flash(r["prompt_len"])
        if r["entry"] != "score":
            for j in range(r["new_tokens"] - 1):
                decode(r["prompt_len"] + j + 1)
    return fl_s, fl_n, dec_s, dec_n
