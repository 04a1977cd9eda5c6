"""The system under test: the port's ``EnginePool`` over ``ServingEngine``s.

Every invocation goes through ``EnginePool.dispatch(function, entry,
tokens, max_new_tokens=...)``; a miss cold-starts an engine
(``ServingEngine.cold_start``), as a FaaS platform would.  Each function
is one deployment of the cell's configuration with weights of its own,
drawn on the card from a seed derived from the run's.

Set-up, all before the window: the load policy (``eager``, or
``profiled``: one eager engine serves the mix's first invocations under
another trace and ``LoadPolicy.from_report`` of its report is the
policy, SlimStart's own loop), the mix's most popular functions made
warm through the pool, and every prompt length the mix can send run
once through each entry it sends.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
from functools import partial

import numpy as np

from portbench.traffic import draw

# the configuration file's keys the program's ArchConfig must match: these
# every file has to state, and any other that names a field of the config
WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "tie_embeddings", "qk_norm", "rope_theta", "norm_eps",
          "moe_group", "dtype")
MOE_WIDTHS = ("n_experts", "top_k", "d_expert_ff", "capacity_factor")


def weight_seed(seed: int, function: int) -> int:
    """Function ``function``'s weight seed in the run of ``seed``."""
    return (seed * 1_000_003 + 7_919 * (function + 1)) % 2**62


# token streams: the window's invocations, then set-up's requests
WINDOW, PREWARM, SHAPES, PROFILE = range(4)


def tokens_for(seed: int, stream: int, i: int, batch: int, length: int,
               vocab: int) -> np.ndarray:
    """Request i's prompt tokens (batch, length) of ``stream`` in the run
    of ``seed``."""
    g = np.random.default_rng([seed % 2**63, stream, i])
    return g.integers(0, vocab, (batch, length), dtype=np.int32)


def _stated(cfg: dict, obj, required) -> list:
    """``required``, then every other key of ``cfg`` that names a field
    of the dataclass ``obj`` (``moe`` aside: its keys go one by one)."""
    fields = {f.name for f in dataclasses.fields(obj)} - {"moe"}
    return list(required) + sorted(k for k in cfg
                                   if k in fields and k not in required)


def _differs(value, stated) -> bool:
    """Whether the config's ``value`` is not the file's ``stated`` (a
    tuple is stated as a JSON list)."""
    return (list(value) if isinstance(value, tuple) else value) != stated


def check_widths(cfg_file: dict, arch) -> None:
    """Raise unless the program's config has the file's numbers: each of
    ``WIDTHS`` and ``MOE_WIDTHS``, and every other key of the file, or
    of its ``moe``, that names a field of the config there."""
    bad = [k for k in _stated(cfg_file, arch, WIDTHS)
           if _differs(getattr(arch, k), cfg_file[k])]
    if (arch.moe is None) != ("moe" not in cfg_file):
        bad.append("moe")
    elif arch.moe is not None:
        moe = cfg_file["moe"]
        bad += [f"moe.{k}" for k in _stated(moe, arch.moe, MOE_WIDTHS)
                if _differs(getattr(arch.moe, k), moe[k])]
    if bad:
        raise SystemExit(f"portbench: {arch.name} differs from its "
                         f"configuration file at {bad}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class System:
    """The pool of one cell's functions, set up and warm."""

    def __init__(self, cfg_file: dict, mix: dict, seed: int, device: str,
                 arch=None):
        import torch
        from repro_torch.configs import get_config
        from repro_torch.serving import EnginePool, LoadPolicy
        self.torch = torch
        self.device = device
        self.cfg_file, self.mix, self.seed = cfg_file, mix, seed
        if arch is None:
            arch = get_config(cfg_file["name"])
            check_widths(cfg_file, arch)
        self.arch = arch
        self.n_functions = mix.get("functions", 1)
        self.names = [f"{arch.name}#{f}" for f in range(self.n_functions)]
        if mix["policy"] == "eager":
            self.policy = LoadPolicy.eager_all()
        else:
            self.policy = self._profiled_policy()
        log(f"[setup] policy lazy={sorted(self.policy.lazy_names)} "
            f"prewarm={sorted(self.policy.prewarm)}")
        self.pool = EnginePool(
            {n: partial(self._engine, f, self.policy)
             for f, n in enumerate(self.names)},
            max_warm=mix["max_warm"])
        for f in range(mix["prewarm"]):
            self.pool.dispatch(self.names[f], "generate",
                               self.tokens(PREWARM, f, mix["prefill_len"]),
                               max_new_tokens=2)
        self._warm_shapes()

    # ------------------------------------------------------------ engines
    def _engine(self, function, policy, seed=None):
        from repro_torch.serving import ServingEngine
        return ServingEngine(
            self.arch, policy=policy,
            seed=weight_seed(self.seed if seed is None else seed, function),
            batch_size=self.mix["batch"], prefill_len=self.mix["prefill_len"],
            max_len=self.mix["max_len"], device=self.device)

    def tokens(self, stream: int, i: int, length: int) -> np.ndarray:
        return tokens_for(self.seed, stream, i, self.mix["batch"], length,
                          self.arch.vocab)

    def _profiled_policy(self):
        """SlimStart's loop: an eager engine serves the mix's first
        ``profile_invocations`` under another trace, with weights and
        tokens of their own; its utilization report gives the policy."""
        from repro_torch.serving import LoadPolicy
        mix = dict(self.mix, trace_seed=self.mix["trace_seed"] + 1000)
        eng = self._engine(0, LoadPolicy.eager_all(), seed=self.seed + 1000)
        eng.cold_start()
        for i in range(self.mix["profile_invocations"]):
            inv = draw.invocation(mix, i)
            eng.serve(inv["entry"],
                      self.tokens(PROFILE, i, inv["prompt_len"]),
                      max_new_tokens=max(inv["new_tokens"], 1))
        policy = LoadPolicy.from_report(eng.report())
        _drop(eng)
        self.free()
        return policy

    def _warm_shapes(self):
        """Each prompt length the mix can send, through each entry it
        sends, on a warm engine (two new tokens: the decode graph is
        already captured at cold start)."""
        eng = self.pool.warm[self.names[0]]
        entries = [e for e, p in sorted(self.mix["entries"].items()) if p]
        for n in draw.prompt_lengths(self.mix["prompt"]):
            for e in entries:
                eng.serve(e, self.tokens(SHAPES, n, n), max_new_tokens=2)

    # ------------------------------------------------------------ serving
    def dispatch(self, inv: dict, toks: np.ndarray):
        """One invocation through the pool: (output, path, cold record or
        None, last logits or None).  A cold record is the new engine's
        cold start and its groups' init seconds, read after the request
        it served.  The last logits are the fp32 logits (B, V) the
        decode graph left from the request's last step, where one ran:
        the only logits a ``generate`` serves."""
        name = self.names[inv["function"]]
        out, _lat, path = self.pool.dispatch(
            name, inv["entry"], toks,
            max_new_tokens=max(inv["new_tokens"], 1))
        eng = self.pool.warm[name]
        cold = None
        if path == "cold":
            rep = eng.registry.report()
            cold = {"function": inv["function"],
                    "cold_start_s": eng.cold_start_s,
                    "by_group": rep["by_group"]}
        exes = eng.registry[f"compile.{inv['entry']}"].value
        graph = exes.get("graph") if isinstance(exes, dict) else None
        last = None
        if graph is not None and inv["new_tokens"] > 1:
            last = graph.logits.cpu().numpy()
        return out, path, cold, last

    def free(self) -> None:
        gc.collect()
        if self.device == "cuda":
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()

    def close(self) -> None:
        """Drop every engine's state, so the card holds none of it."""
        for eng in list(self.pool.warm.values()):
            _drop(eng)
        self.pool.warm.clear()
        self.free()


def _drop(eng) -> None:
    for comp in eng.registry.values():
        comp.drop()
