"""Whether what the timed path served is right: the decision ``correct``.

Once the window has closed, the peak memory has been read and the
program's state is freed, the plain float32 reference of the cell's
configuration runs once over a sample of the finished invocations,
drawn from the run's seed: the one with the longest prompt, one of each
dispatch path that served any (a cold start's first request among
them), then more until ``check_tokens`` served tokens are in it; and
one ``score`` invocation where any finished.

What is compared: for each served token, by how far the reference's
logit for it lies below the reference's best at that position, in
units of the reference logits' standard deviation over the vocabulary
(``gen_gap``, the widest over the sample); for a ``score``, the same of
the token the program's logits put first at each prompt position
(``score_gap``).  An altered token lies tens of deviations below.  And
the logits the program served, against the reference's at the same
positions: the rms of their difference over the vocabulary, in the
same units (``logit_err``, the widest over the rows): a ``score``'s
logits, and a ``generate``'s last decode step's, which the decode
graph leaves in its output buffer.  ``logit_err`` is the number that
sees precision: with random weights and a tied embedding, granite-8b's
greedy token repeats the last one by tens of deviations, so no
rounding moves a token.  An invocation that failed or never returned
makes the run not correct (``failed``, limit 0).  The limits are the
cell's ``limits/<cell>.json``, set from readings of the program and of
the control (``calibrate.py``).

Which reference: the module ``reference/<stem>.py`` that the
configuration file names by ``"reference": "<stem>"`` (its ``draw`` and
``logits``; see ``reference/__init__.py``), loaded from the portbench
directory the cell's files came from; for a file without the key,
``reference.weights.draw`` and ``reference.model.logits``.
"""

from __future__ import annotations

import numpy as np

from portbench import reference, system


def sample(records, outputs, mix, seed):
    """The generate and score records the reference checks."""
    rng = np.random.default_rng([seed % 2**63, 99])
    done = [r for r in records if r["ok"] and r["i"] in outputs]
    gen = [done[j] for j in rng.permutation(len(done))
           if done[j]["entry"] != "score"]
    scores = [r for r in done if r["entry"] == "score"]
    picked = []
    if gen:
        picked.append(max(gen, key=lambda r: r["prompt_len"]))
    for path in sorted({r["path"] for r in gen}):
        first = next(r for r in gen if r["path"] == path)
        if first not in picked:
            picked.append(first)
    for r in gen:
        if sum(p["new_tokens"] for p in picked) * mix["batch"] >= \
                mix["check_tokens"]:
            break
        if r not in picked:
            picked.append(r)
    if scores:
        picked.append(scores[int(rng.integers(len(scores)))])
    return picked


def _gap(ref, chosen):
    """Widest (best - ref[chosen]) / std over the vocabulary."""
    best = ref.max(-1).values
    got = ref.gather(-1, chosen[..., None])[..., 0]
    return float(((best - got) / ref.std(-1)).max())


def _errs(prog, ref):
    """Each logit vector's rms over the vocabulary of (prog - ref), over
    ref's std there."""
    return ((prog - ref).square().mean(-1).sqrt()
            / ref.std(-1)).flatten().tolist()


def reference_of(cfg):
    """(draw, logits) of the configuration's reference."""
    own = reference.module(cfg)
    if own is not None:
        return own.draw, own.logits
    from portbench.reference import model, weights
    return weights.draw, model.logits


def reference_gaps(cfg, picked, outputs, seed, device, *, last_logits=None,
                   control=False):
    """{'gen_gap', 'score_gap', 'logit_err'} of the program on
    ``picked`` (``logit_err`` where it served logits: a score's, or the
    last decode step's that ``last_logits`` holds).  With ``control``,
    the same of the fp8 reference, each under its name + '_control':
    the gaps of the tokens it puts first, its logits' error.
    ``logit_err`` is the widest over the logit vectors compared,
    ``logit_err_med`` their median, ``logit_err_q1`` their lower
    quartile; ``mismatch`` is the share of served
    tokens that are not the reference's first."""
    import torch
    draw, ref_logits = reference_of(cfg)
    last_logits = last_logits or {}
    out = {}
    errs = {"logit_err": [], "logit_err_control": []}
    miss = {"mismatch": [0, 0], "mismatch_control": [0, 0]}

    def count(key, chosen, ref):
        miss[key][0] += int((chosen != ref.argmax(-1)).sum())
        miss[key][1] += chosen.numel()

    def put(key, v):
        out[key] = max(out.get(key, v), v)

    for f in sorted({r["function"] for r in picked}):
        params = draw(cfg, system.weight_seed(seed, f), device)
        for r in (r for r in picked if r["function"] == f):
            S = r["prompt_len"]
            prompt = system.tokens_for(seed, system.WINDOW, r["i"],
                                       outputs[r["i"]].shape[0], S,
                                       cfg["vocab"])
            served_logits = None
            if r["entry"] == "score":
                full, pos = prompt, list(range(S))
                served_logits = torch.as_tensor(outputs[r["i"]],
                                                device=device)
                prog, key = served_logits.argmax(-1), "score_gap"
                err_at = slice(None)
            else:
                served = outputs[r["i"]]
                full = np.concatenate([prompt, served[:, :-1]], axis=1)
                pos = list(range(S - 1, S - 1 + served.shape[1]))
                prog, key = served, "gen_gap"
                err_at = slice(-1, None)
                if r["i"] in last_logits:
                    served_logits = torch.as_tensor(
                        last_logits[r["i"]], device=device)[:, None]
            toks = torch.as_tensor(full, dtype=torch.long, device=device)
            ref = ref_logits(cfg, params, toks, pos, prefill_len=S)
            prog = torch.as_tensor(prog, dtype=torch.long, device=device)
            put(key, _gap(ref, prog))
            if key == "gen_gap":
                count("mismatch", prog, ref)
            if served_logits is not None:
                errs["logit_err"] += _errs(served_logits, ref[:, err_at])
            if control:
                low = ref_logits(cfg, params, toks, pos, prefill_len=S,
                                 fp8=True)
                put(key + "_control", _gap(ref, low.argmax(-1)))
                if key == "gen_gap":
                    count("mismatch_control", low.argmax(-1), ref)
                errs["logit_err_control"] += _errs(low[:, err_at],
                                                   ref[:, err_at])
                del low
            del ref, served_logits
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
    for key, (n, of) in miss.items():
        if of:
            out[key] = n / of
    for key, vals in errs.items():
        if vals:
            out[key] = max(vals)
            out[key.replace("logit_err", "logit_err_med")] = \
                float(np.median(vals))
            out[key.replace("logit_err", "logit_err_q1")] = \
                float(np.quantile(vals, 0.25))
    return out


def judge(gaps: dict, failed: int, limits: dict):
    """(correct, checks): each number the cell's limits name, compared
    with its limit.  A number the run could not read (a ``score_gap``
    where no score finished) is left out; with no token checked at all
    the run is not correct."""
    checks = {"failed": {"value": failed, "limit": 0}}
    for key, limit in limits.items():
        if key in gaps:
            checks[key] = {"value": gaps[key], "limit": limit}
    correct = failed == 0 and "gen_gap" in gaps and all(
        c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
