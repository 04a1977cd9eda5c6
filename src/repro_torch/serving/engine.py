"""Serverless serving engine with SLIMSTART-guided cold starts (PyTorch
port of ``repro.serving.engine.ServingEngine``: dense, recurrent and MoE
decoders, pixtral and whisper).

Cold-start anatomy (the Level-B "library loading"):
    import -> config -> weight materialization -> entry-point warm-up
Each stage is a named ``Component``; the engine materializes the eager
set per ``LoadPolicy``, serves requests (materializing lazy components
on first use, exactly like a deferred import), and tracks per-entry
invocations + per-expert routing mass as the utilization signal for the
profile-guided optimizer (``engine.report()`` ->
``LoadPolicy.from_report``).

Entries, in the reference's order: ``generate`` (prefill + greedy
decode), ``vision_generate`` (pixtral: the same with ``patch_embeds``
in front of the prompt), ``transcribe`` (whisper: the same with the
encoder over ``enc_frames``) and ``score`` (teacher-forced logits).
``serve(..., extras=)`` takes an entry's extras and fills a missing one
with zeros, as the reference does; ``generate`` and ``score`` on
whisper run its encoder on zero frames.  The modality frontends are
components of group ``frontend`` (``frontend.vision``,
``frontend.audio_encoder``) with no-op builders, as in the reference,
materialized on their entry's first use where the policy defers them.

An MoE model's experts are components of their own (``expert.<e>``,
group ``experts``): ``weights.core`` leaves every expert's FF weights at
zero, and an expert's builder draws its slice of every MoE layer in
place.  As in the reference, a request's prefill runs before the experts
it routed to are materialized, so a request that first routes to a cold
expert is served with that expert's zero weights.

Where the reference compiles each entry ahead of time
(``jax.jit(...).lower(...).compile()``), the port's ``compile.<entry>``
component runs the entry once at its fixed shapes: that builds the CUDA
kernels on first use and loads them, and it stays a real, timed
component init.
"""

from __future__ import annotations

import time
import zlib
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


# the frontend component each entry materializes on first use
FRONTENDS = {"vision_generate": "frontend.vision",
             "transcribe": "frontend.audio_encoder"}


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
        self.expert_mass: Optional[np.ndarray] = None
        self._params = None
        self.cold_start_s: Optional[float] = None
        self._build_components()

    # ------------------------------------------------------------ build
    def _build_components(self):
        reg = self.registry
        moe = self.cfg.moe

        def weights_builder():
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            # expert FF weights are materialized per expert instead
            return init_params(self.cfg, gen, self.device,
                               blank_experts=moe is not None)

        reg.add(Component("weights.core", "weights", weights_builder))
        if moe is not None:
            for e in range(moe.n_experts):
                reg.add(Component(f"expert.{e}", "experts",
                                  partial(self._expert_builder, e)))
        # the stub frontends: vision_proj is in weights.core and the
        # encoder runs inside the entries, so the builders do nothing
        for entry, name in FRONTENDS.items():
            if entry in self.entries():
                reg.add(Component(name, "frontend", lambda: True))
        # per-entry warm-ups (the Level-B analogue of importing the
        # module that serves this handler)
        for entry in self.entries():
            reg.add(Component(f"compile.{entry}", "compile",
                              partial(self._compile_entry, entry)))

    def entries(self) -> list[str]:
        cfg = self.cfg
        out = ["generate"]
        if cfg.vision_tokens:
            out.append("vision_generate")
        if cfg.encoder_layers:
            out.append("transcribe")
        out.append("score")  # rarely-hit teacher forcing
        return out

    def _entry_shapes(self, entry: str) -> dict:
        """The extras ``entry`` takes: {name: (shape, dtype)}."""
        cfg, B = self.cfg, self.B
        if entry == "vision_generate" and cfg.vision_tokens:
            return {"patch_embeds": ((B, cfg.vision_tokens, cfg.d_model),
                                     cfg.tdtype)}
        if entry == "transcribe" and cfg.encoder_layers:
            return {"enc_frames": ((B, cfg.encoder_seq, cfg.d_model),
                                   cfg.tdtype)}
        return {}

    def _extras(self, entry: str, given: Optional[dict]) -> dict:
        """The given extras on the device in the model dtype, and zeros
        for each of the entry's extras not given."""
        out = {k: torch.as_tensor(np.asarray(v), dtype=self.cfg.tdtype,
                                  device=self.device)
               for k, v in (given or {}).items()}
        for k, (shape, dtype) in self._entry_shapes(entry).items():
            if k not in out:
                out[k] = torch.zeros(shape, dtype=dtype, device=self.device)
        return out

    # ---------------------------------------------------------- experts
    def _expert_builder(self, e: int):
        """Draw expert e's FF weights (normal / sqrt(fan-in)) into its
        slice of every MoE layer's stacked ``wi``/``wo``, in place.

        Each leaf's draw comes from a generator keyed by (seed, e, layer
        path, leaf) through crc32, so it is the same in every process
        (the reference keys it by Python's ``hash``, which is not)."""
        params = self._ensure_params()

        def visit(tree, path=""):
            for k, v in sorted(tree.items()):
                if k == "moe":
                    for w in ("wi", "wo"):
                        key = zlib.crc32(f"{self.seed}/{e}/{path}/{w}"
                                         .encode())
                        gen = torch.Generator(device=self.device)
                        gen.manual_seed(key)
                        leaf = v[w]  # (n_stack, E, fan_in, out)
                        leaf[:, e].normal_(0.0, leaf.shape[2] ** -0.5,
                                           generator=gen)
                elif isinstance(v, dict):
                    visit(v, f"{path}/{k}")
        visit(params["layers"])
        return e

    # ------------------------------------------------------ compilation
    def _compile_entry(self, entry: str):
        cfg = self.cfg
        params = self._ensure_params()
        toks = torch.zeros((self.B, self.prefill_len), dtype=torch.int32,
                           device=self.device)
        cache_len = self.max_len + cfg.vision_tokens

        if entry == "score":
            def score_fn(params, tokens):
                h, _, _ = forward(cfg, params, tokens)
                return _head(cfg, params, h)
            score_fn(params, toks)
            return {"score": score_fn}

        def prefill_fn(params, tokens, extra):
            logits, caches, aux = prefill(cfg, params, tokens,
                                          cache_len=cache_len, **extra)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            return nxt, caches, aux.get("expert_load")

        def decode_fn(params, token, pos, caches):
            logits, caches = decode_step(cfg, params, token, pos, caches)
            return logits.argmax(dim=-1).to(torch.int32)[:, None], caches

        nxt, caches, _ = prefill_fn(params, toks, self._extras(entry, None))
        pos = torch.full((self.B,), self._pos0(entry, self.prefill_len),
                         dtype=torch.int32, device=self.device)
        decode_fn(params, nxt[:, None], pos, caches)
        return {"prefill": prefill_fn, "decode": decode_fn}

    def _pos0(self, entry: str, prompt_len: int) -> int:
        """The first decode position: after the prompt and, for
        ``vision_generate``, the vision prefix."""
        vt = self.cfg.vision_tokens if entry == "vision_generate" else 0
        return prompt_len + vt

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
              max_new_tokens: int = 8, extras: Optional[dict] = None):
        """Serve one batched request; returns (tokens_out, latency_s).

        ``generate``, ``vision_generate`` and ``transcribe`` return the
        greedy tokens (B, max_new_tokens); ``score`` returns the fp32
        logits of every position (B, S, V).  ``extras``: the entry's
        ``patch_embeds`` or ``enc_frames`` (zeros where absent).
        """
        t0 = time.perf_counter()
        self.entry_counts[entry] = self.entry_counts.get(entry, 0) + 1
        params = self._ensure_params()
        exes = self.registry[f"compile.{entry}"].get()
        if entry in FRONTENDS:
            self.registry[FRONTENDS[entry]].get()
        self.registry["weights.core"].uses += 1  # every request hits them
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)
        if entry == "score":
            out = exes["score"](params, toks).cpu().numpy()
            return out, time.perf_counter() - t0

        nxt, caches, load = exes["prefill"](params, toks,
                                            self._extras(entry, extras))
        if load is not None:
            self._account_experts(load.cpu().numpy())
        pos0 = self._pos0(entry, toks.shape[1])
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
    def _account_experts(self, load: np.ndarray):
        """Routing mass -> expert Component.uses; materialize experts
        that received traffic but are still cold (lazy loading)."""
        if self.expert_mass is None:
            self.expert_mass = np.zeros_like(load)
        self.expert_mass += load
        for e, mass in enumerate(load):
            name = f"expert.{e}"
            if name in self.registry and mass > 0:
                comp = self.registry[name]
                if not comp.ready:
                    comp.get()  # deferred materialization on first route
                else:
                    comp.uses += 1

    def report(self) -> dict:
        rep = self.registry.report()
        rep["entry_counts"] = dict(self.entry_counts)
        rep["cold_start_s"] = self.cold_start_s
        if self.expert_mass is not None:
            tot = float(self.expert_mass.sum()) or 1.0
            rep["expert_utilization"] = {
                f"expert.{e}": round(float(m) / tot, 4)
                for e, m in enumerate(self.expert_mass)}
            # fold routing mass into component utilization rows
            for row in rep["components"]:
                if row["component"].startswith("expert."):
                    row["utilization"] = rep["expert_utilization"].get(
                        row["component"], 0.0)
        return rep
