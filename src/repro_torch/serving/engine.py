"""Serverless serving engine with SLIMSTART-guided cold starts (PyTorch
port of ``repro.serving.engine.ServingEngine``, dense configs).

Cold-start anatomy (the Level-B "library loading"):
    import -> config -> weight materialization -> entry-point warm-up
Each stage is a named ``Component``; the engine materializes the eager
set per ``LoadPolicy``, serves requests (materializing lazy components
on first use, exactly like a deferred import), and tracks per-entry
invocations as the utilization signal for the profile-guided optimizer
(``engine.report()`` -> ``LoadPolicy.from_report``).

Where the reference compiles each entry ahead of time
(``jax.jit(...).lower(...).compile()``), the port's ``compile.<entry>``
component runs the entry once at its fixed shapes: that builds the CUDA
kernels on first use and loads them, and it stays a real, timed
component init.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (
    _head, check_supported, decode_step, forward, init_params, prefill,
)
from repro_torch.serving.components import (
    Component, ComponentRegistry, LoadPolicy,
)


class ServingEngine:
    """One model server instance ("function instance" in FaaS terms).

    Runs on ``device`` ("cuda" unless the caller passes "cpu"); asking
    for CUDA where there is none raises instead of running on the CPU.
    """

    def __init__(self, cfg: ArchConfig, *, policy: Optional[LoadPolicy]
                 = None, seed: int = 0, batch_size: int = 1,
                 prefill_len: int = 32, max_len: int = 96,
                 device: str = "cuda"):
        check_supported(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine: CUDA is not available; pass "
                               "device='cpu' to run the plain path")
        self.cfg = cfg
        self.policy = policy or LoadPolicy.eager_all()
        self.seed = seed
        self.B = batch_size
        self.prefill_len = prefill_len
        self.max_len = max_len
        self.registry = ComponentRegistry()
        self.entry_counts: dict[str, int] = {}
        self._params = None
        self.cold_start_s: Optional[float] = None
        self._build_components()

    # ------------------------------------------------------------ build
    def _build_components(self):
        reg = self.registry

        def weights_builder():
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            return init_params(self.cfg, gen, self.device)

        reg.add(Component("weights.core", "weights", weights_builder))
        # per-entry warm-ups (the Level-B analogue of importing the
        # module that serves this handler)
        for entry in self.entries():
            reg.add(Component(f"compile.{entry}", "compile",
                              partial(self._compile_entry, entry)))

    def entries(self) -> list[str]:
        return ["generate", "score"]  # score: rarely-hit teacher forcing

    # ------------------------------------------------------ compilation
    def _compile_entry(self, entry: str):
        cfg = self.cfg
        params = self._ensure_params()
        toks = torch.zeros((self.B, self.prefill_len), dtype=torch.int32,
                           device=self.device)

        if entry == "score":
            def score_fn(params, tokens):
                h, _, _ = forward(cfg, params, tokens)
                return _head(cfg, params, h)
            score_fn(params, toks)
            return {"score": score_fn}

        def prefill_fn(params, tokens):
            logits, caches, _ = prefill(cfg, params, tokens,
                                        cache_len=self.max_len)
            return logits.argmax(dim=-1).to(torch.int32), caches

        def decode_fn(params, token, pos, caches):
            logits, caches = decode_step(cfg, params, token, pos, caches)
            return logits.argmax(dim=-1).to(torch.int32)[:, None], caches

        nxt, caches = prefill_fn(params, toks)
        pos = torch.full((self.B,), self.prefill_len, dtype=torch.int32,
                         device=self.device)
        decode_fn(params, nxt[:, None], pos, caches)
        return {"prefill": prefill_fn, "decode": decode_fn}

    def _ensure_params(self):
        if self._params is None:
            self._params = self.registry["weights.core"].get()
            self.registry["weights.core"].uses -= 1  # counted per request
        return self._params

    # ---------------------------------------------------------- serving
    def cold_start(self):
        """Materialize the eager set; returns wall seconds."""
        t0 = time.perf_counter()
        self._ensure_params()
        self.registry.materialize_eager(self.policy)
        self.cold_start_s = time.perf_counter() - t0
        return self.cold_start_s

    def serve(self, entry: str, tokens: np.ndarray, *,
              max_new_tokens: int = 8):
        """Serve one batched request; returns (tokens_out, latency_s).

        ``generate`` returns the greedy tokens (B, max_new_tokens);
        ``score`` returns the fp32 logits of every position (B, S, V).
        """
        t0 = time.perf_counter()
        self.entry_counts[entry] = self.entry_counts.get(entry, 0) + 1
        params = self._ensure_params()
        exes = self.registry[f"compile.{entry}"].get()
        self.registry["weights.core"].uses += 1  # every request hits them
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)
        if entry == "score":
            out = exes["score"](params, toks).cpu().numpy()
            return out, time.perf_counter() - t0

        nxt, caches = exes["prefill"](params, toks)
        pos0 = toks.shape[1]
        out = [nxt]
        tok = nxt[:, None]
        for i in range(max_new_tokens - 1):
            pos = torch.full((self.B,), pos0 + i, dtype=torch.int32,
                             device=self.device)
            tok, caches = exes["decode"](params, tok, pos, caches)
            out.append(tok[:, 0])
        result = torch.stack(out, dim=1).cpu().numpy()
        return result, time.perf_counter() - t0

    # ----------------------------------------- utilization / SLIMSTART
    def report(self) -> dict:
        rep = self.registry.report()
        rep["entry_counts"] = dict(self.entry_counts)
        rep["cold_start_s"] = self.cold_start_s
        return rep
