"""Serverless serving engine with SLIMSTART-guided cold starts (PyTorch
port of ``repro.serving.engine.ServingEngine``, for every architecture
of the reference).

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
component runs the entry once at its fixed shapes (that builds the CUDA
kernels on first use and loads them) and, on a CUDA engine, captures a
generating entry's decode step as a CUDA graph (``graphs.DecodeGraph``)
with static caches of the engine's batch and cache length: ``serve``
writes the prefill into those caches and replays the graph for each
step.  The capture is part of the component's timed init, as the
reference's compile is.  A CPU engine (``device="cpu"``) decodes
eagerly.  A serve's batch must be the engine's ``batch_size``, as the
reference's compiled executables require.

:class:`EnginePool` adds the fleet layer on top (the reference's, with
the same semantics): pool-aware dispatch across many models -- requests
route to a warm engine when one is resident, fall back to a cold start
(building and admitting a fresh engine, evicting the worst-amortizing
one past the budget and dropping its components, so its weights, static
caches and graphs leave the card), and the pool's ``rewarm`` method
plugs into ``SlimStartController(rewarm_fn=...)``.
"""

from __future__ import annotations

import threading
import time
import zlib
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import moe_decode
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import moe_rows
from repro_torch.models.model import (
    _head, decode_step, forward, init_cache, init_params, prefill,
)
from repro_torch.obs.tracing import get_tracer
from repro_torch.serving.components import (
    Component, ComponentRegistry, LoadPolicy,
)
from repro_torch.serving.graphs import DecodeGraph


def _m_engine_dispatch(model: str, path: str) -> None:
    from repro_torch.obs.metrics import default_registry
    default_registry().counter(
        "repro_engine_dispatch_total",
        "EnginePool dispatches by path (warm/cold/queued/shed)",
        labels=("model", "path")).labels(model=model, path=path).inc()


# the frontend component each entry materializes on first use
FRONTENDS = {"vision_generate": "frontend.vision",
             "transcribe": "frontend.audio_encoder"}


class ServingEngine:
    """One model server instance ("function instance" in FaaS terms).

    Runs on ``device`` ("cuda" unless the caller passes "cpu"); asking
    for CUDA where there is none raises instead of running on the CPU.

    Unlike the reference's compiled executables, which are re-entrant,
    a CUDA engine's decode graphs replay into static buffers, so an
    engine serves one request at a time: ``serve`` holds a per-engine
    lock (concurrent serves queue and give the tokens sequential ones
    would).  The parameters are read through ``weights.core`` each
    time (``_params``), so dropping the components leaves the engine
    holding no device memory.
    """

    def __init__(self, cfg: ArchConfig, *, policy: Optional[LoadPolicy]
                 = None, seed: int = 0, batch_size: int = 1,
                 prefill_len: int = 32, max_len: int = 96,
                 device: str = "cuda"):
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
        self.cold_start_s: Optional[float] = None
        self._serve_lock = threading.Lock()
        self._span = None  # the ``serve`` span of the serve under way
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
        """The entry's executables, run once at the engine's shapes.

        ``score``: the eager forward.  A generating entry: ``prefill``
        (eager; ``caches=`` writes into a given cache tree) and
        ``decode`` (the eager step); on a CUDA engine also ``graph``,
        the step captured as a ``DecodeGraph`` whose static caches the
        warm-up's prefill fills."""
        cfg = self.cfg
        tracer = get_tracer()
        params = self._ensure_params()
        toks = torch.zeros((self.B, self.prefill_len), dtype=torch.int32,
                           device=self.device)
        cache_len = self.max_len + cfg.vision_tokens

        if entry == "score":
            def score_fn(params, tokens):
                h, _, _ = forward(cfg, params, tokens)
                return _head(cfg, params, h)
            with tracer.span("warmup"):
                score_fn(params, toks)
            return {"score": score_fn}

        def prefill_fn(params, tokens, extra, caches=None):
            logits, caches, aux = prefill(cfg, params, tokens,
                                          cache_len=cache_len,
                                          caches=caches, **extra)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            return nxt, caches, aux.get("expert_load")

        def decode_fn(params, token, pos, caches):
            logits, caches = decode_step(cfg, params, token, pos, caches)
            return logits.argmax(dim=-1).to(torch.int32)[:, None], caches

        exes = {"prefill": prefill_fn, "decode": decode_fn}
        extra = self._extras(entry, None)
        if self.device.type == "cuda":
            caches = init_cache(cfg, self.B, cache_len, self.device)
            with tracer.span("warmup"):
                prefill_fn(params, toks, extra, caches)
            with tracer.span("graph_capture"):
                exes["graph"] = DecodeGraph(partial(decode_step, cfg),
                                            params, caches, self.B,
                                            self.device)
            return exes
        with tracer.span("warmup"):
            nxt, caches, _ = prefill_fn(params, toks, extra)
            pos = torch.full((self.B,), self._pos0(entry, self.prefill_len),
                             dtype=torch.int32, device=self.device)
            decode_fn(params, nxt[:, None], pos, caches)
        return exes

    def _pos0(self, entry: str, prompt_len: int) -> int:
        """The first decode position: after the prompt and, for
        ``vision_generate``, the vision prefix."""
        vt = self.cfg.vision_tokens if entry == "vision_generate" else 0
        return prompt_len + vt

    @property
    def _params(self):
        """The parameter tree while ``weights.core`` is materialized."""
        return self.registry["weights.core"].value

    def _ensure_params(self):
        comp = self.registry["weights.core"]
        if not comp.ready:
            comp.get()
            comp.uses -= 1  # counted per request
        return comp.value

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
        ``patch_embeds`` or ``enc_frames`` (zeros where absent).  B must
        be the engine's batch size.  One serve at a time per engine (the
        class docstring says why); the latency includes the wait.

        The ``serve`` span (lock wait included) carries the request's
        shape and, for a generating entry, the device time of its
        prefill and of its decode steps (``_Stamps``) and, where the
        decode step runs the expert-sparse MoE kernels, the experts they
        read (``_expert_counter``).
        """
        t0 = time.perf_counter()
        shape = np.shape(tokens)
        if shape[0] != self.B:
            raise ValueError(f"serve: batch {shape[0]}, the "
                             f"engine's is {self.B}")
        with get_tracer().span(
                "serve", entry=entry, batch=self.B, prompt_len=shape[1],
                new_tokens=0 if entry == "score" else max_new_tokens) as sp:
            with self._serve_lock:
                self._span = sp  # the serve under way (one at a time)
                out = self._serve(entry, tokens, max_new_tokens, extras)
        return out, time.perf_counter() - t0

    def _serve(self, entry, tokens, max_new_tokens, extras):
        self.entry_counts[entry] = self.entry_counts.get(entry, 0) + 1
        params = self._ensure_params()
        exes = self.registry[f"compile.{entry}"].get()
        if entry in FRONTENDS:
            self.registry[FRONTENDS[entry]].get()
        self.registry["weights.core"].uses += 1  # every request hits them
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)
        if entry == "score":
            return exes["score"](params, toks).cpu().numpy()

        graph = exes.get("graph")
        extra = self._extras(entry, extras)
        sp = self._span
        st = _Stamps(self.device) if sp.recording else _NO_STAMPS
        st.mark()
        nxt, caches, load = exes["prefill"](
            params, toks, extra, None if graph is None else graph.caches)
        st.mark()
        if load is not None:
            self._account_experts(load.cpu().numpy())
        pos0 = self._pos0(entry, toks.shape[1])
        out = [nxt]
        tok = nxt[:, None]
        counter = self._expert_counter() if sp.recording else None
        read0 = None if counter is None else counter.clone()
        st.mark()
        for i in range(max_new_tokens - 1):
            if graph is not None:
                tok, _ = graph(tok, pos0 + i)
                out.append(tok[:, 0].clone())  # the next replay overwrites
                continue
            pos = torch.full((self.B,), pos0 + i, dtype=torch.int32,
                             device=self.device)
            tok, caches = exes["decode"](params, tok, pos, caches)
            out.append(tok[:, 0])
        st.mark()
        res = torch.stack(out, dim=1).cpu().numpy()  # synchronises
        st.report(sp, max_new_tokens - 1)
        if counter is not None:
            sp.set("moe_experts_read", int(counter.item() - read0.item()))
            sp.set("moe_expert_slots", self.cfg.moe.n_experts
                   * self.cfg.n_layers * (max_new_tokens - 1))
        return res

    def _expert_counter(self):
        """``moe_decode.experts_read`` of this engine's card where its
        decode step runs the expert-sparse MoE kernels (a CUDA MoE engine
        whose batch gives at most ``moe_decode.R_MAX`` rows per expert),
        else None.  The ``serve`` span then carries
        ``moe_experts_read``, the counter's increase over the decode
        steps, and ``moe_expert_slots``, experts x MoE layers x steps."""
        cfg = self.cfg
        if cfg.moe is None or self.device.type != "cuda" \
                or moe_rows(cfg, self.B) > moe_decode.R_MAX:
            return None
        return moe_decode.experts_read(self.device)

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


class _Stamps:
    """The ``serve`` span's four stamps: before the prefill's first
    launch, after its argmax, before the first decode step and after the
    last.  CUDA events on the engine's stream on a CUDA engine, read
    after the output's copy to the host (which synchronises already);
    the host clock on a CPU engine, which runs synchronously.
    ``report`` sets ``prefill_device_ms``, ``decode_device_ms`` and
    ``decode_steps`` on the span."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.marks: list = []

    def mark(self) -> None:
        if self.stream is None:
            self.marks.append(time.perf_counter())
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.marks.append(ev)

    def _ms(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        if self.stream is None:
            return (b - a) * 1e3
        return a.elapsed_time(b)

    def report(self, sp, steps: int) -> None:
        sp.set("prefill_device_ms", self._ms(0, 1))
        sp.set("decode_device_ms", self._ms(2, 3))
        sp.set("decode_steps", steps)


class _NoStamps:
    __slots__ = ()

    def mark(self) -> None:
        pass

    def report(self, sp, steps: int) -> None:
        pass


_NO_STAMPS = _NoStamps()


class PoolSaturated(RuntimeError):
    """Backpressure: a model's cold-start wait queue is full, the
    request was shed instead of piling more load on a cold pool."""


class EnginePool:
    """Pool-aware dispatch across warm :class:`ServingEngine` instances
    (the reference's ``repro.serving.EnginePool``, same semantics).

    Each *model* is an app, a warm engine is a resident instance, and
    ``max_warm`` is the shared budget.  ``dispatch`` routes a request to
    the model's warm engine; on a miss it cold-starts a fresh engine
    (``builders[model]``), and past the budget it evicts the warm engine
    that amortizes worst -- fewest cold-start seconds saved per dispatch
    since admission -- dropping its components so the memory is
    actually released (on the card: its weights, static caches, decode
    graphs and their scratch).  As in the reference, the new engine is
    built before the victim is dropped.

    ``queue_depth`` turns on **queue-aware dispatch** for concurrent
    callers: while one thread cold-starts a model, other requests for
    the same model *wait* for that one engine instead of each building
    a duplicate (single-flight), at most ``queue_depth`` of them -- the
    next raises :class:`PoolSaturated` and is counted as a shed.
    Waiters return with path ``"queued"`` and their wait recorded in
    ``queue_waits_s``.  ``queue_depth=None`` (default) keeps the
    legacy single-threaded behavior.  ``fault_hook`` is any callable,
    called as ``fault_hook("cold_start", app=model)`` at the cold-start
    site.
    """

    def __init__(self, builders: dict[str, Callable[[], "ServingEngine"]],
                 *, max_warm: int = 2,
                 queue_depth: Optional[int] = None,
                 fault_hook=None) -> None:
        if max_warm < 1:
            raise ValueError("max_warm must be >= 1")
        if queue_depth is not None and queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        self.fault_hook = fault_hook
        self.builders = dict(builders)
        self.max_warm = max_warm
        self.queue_depth = queue_depth
        self.warm: dict[str, ServingEngine] = {}
        self.hits = 0
        self.misses = 0
        self.sheds = 0
        self.evictions: list[str] = []
        self.queue_waits_s: list[float] = []
        self._dispatches: dict[str, int] = {}
        self._lock = threading.Lock()
        # model -> Event set once its in-flight cold start finishes
        self._cold_events: dict[str, threading.Event] = {}
        self._cold_waiters: dict[str, int] = {}
        # queue mode only: an engine with serves in flight keeps its
        # components until the last serve returns
        self._serving: dict[int, int] = {}          # id(engine) -> count
        self._drop_pending: dict[int, tuple[str, "ServingEngine"]] = {}

    # ----------------------------------------------------------- dispatch
    def dispatch(self, model: str, entry: str, tokens, **kw):
        """Serve one request; returns ``(output, latency_s, path)`` with
        ``path`` in {"warm", "cold", "queued"}.  Cold latency includes
        the engine's cold start, as a FaaS cold invocation's does;
        queued latency includes the wait for the in-flight one."""
        if model not in self.builders:
            raise KeyError(f"unknown model {model!r}")
        with get_tracer().span("engine_dispatch", model=model,
                               entry=entry) as sp:
            try:
                if self.queue_depth is None:
                    out, lat, path = self._dispatch_unlocked(
                        model, entry, tokens, _ctx=sp.ctx(), **kw)
                else:
                    out, lat, path = self._dispatch_queued(
                        model, entry, tokens, _ctx=sp.ctx(), **kw)
            except PoolSaturated:
                sp.set("path", "shed")
                _m_engine_dispatch(model, "shed")
                raise
            sp.set("path", path)
            _m_engine_dispatch(model, path)
            return out, lat, path

    def _cold_start(self, model: str, _ctx: Optional[dict]):
        """Build and cold-start a fresh engine; (engine, cold_s)."""
        with get_tracer().span("cold_start", ctx=_ctx, model=model):
            if self.fault_hook is not None:
                self.fault_hook("cold_start", app=model)
            eng = self.builders[model]()
            return eng, eng.cold_start()

    def _dispatch_unlocked(self, model: str, entry: str, tokens,
                           _ctx: Optional[dict] = None, **kw):
        eng = self.warm.get(model)
        if eng is not None:
            self.hits += 1
            self._dispatches[model] = self._dispatches.get(model, 0) + 1
            out, lat = eng.serve(entry, tokens, **kw)
            return out, lat, "warm"
        self.misses += 1
        eng, cold_s = self._cold_start(model, _ctx)
        self._admit(model, eng)
        self._dispatches[model] = self._dispatches.get(model, 0) + 1
        out, lat = eng.serve(entry, tokens, **kw)
        return out, lat + cold_s, "cold"

    def _dispatch_queued(self, model: str, entry: str, tokens,
                         _ctx: Optional[dict] = None, **kw):
        t0 = time.perf_counter()
        waited = False
        wait_s = 0.0
        while True:
            evt: Optional[threading.Event] = None
            with self._lock:
                eng = self.warm.get(model)
                if eng is not None:
                    self.hits += 1
                    self._dispatches[model] = \
                        self._dispatches.get(model, 0) + 1
                    if waited:
                        wait_s = time.perf_counter() - t0
                        self.queue_waits_s.append(wait_s)
                    path = "queued" if waited else "warm"
                elif model not in self._cold_events:
                    # we are the builder: single-flight the cold start
                    self._cold_events[model] = threading.Event()
                    path = "build"
                else:
                    if self._cold_waiters.get(model, 0) \
                            >= self.queue_depth:
                        self.sheds += 1
                        raise PoolSaturated(
                            f"model {model!r}: {self.queue_depth} "
                            f"requests already wait on its cold start")
                    self._cold_waiters[model] = \
                        self._cold_waiters.get(model, 0) + 1
                    evt = self._cold_events[model]
                    path = "wait"
            if path in ("warm", "queued"):
                out, lat = self._serve_counted(eng, entry, tokens, **kw)
                return out, lat + wait_s, path
            if path == "build":
                try:
                    eng, cold_s = self._cold_start(model, _ctx)
                    with self._lock:
                        self.misses += 1
                        self._admit(model, eng)
                        self._dispatches[model] = \
                            self._dispatches.get(model, 0) + 1
                finally:
                    # wake waiters even on a failed build: one of them
                    # retries as the next builder
                    with self._lock:
                        self._cold_events.pop(model).set()
                out, lat = self._serve_counted(eng, entry, tokens, **kw)
                return out, lat + cold_s, "cold"
            # path == "wait": block until the in-flight build finishes
            evt.wait()
            with self._lock:
                self._cold_waiters[model] = max(
                    self._cold_waiters.get(model, 1) - 1, 0)
            waited = True

    def _serve_counted(self, eng: "ServingEngine", entry: str, tokens,
                       **kw):
        """Serve while holding an in-flight ticket on the engine, so a
        concurrent eviction defers its component drop (queue mode)."""
        key = id(eng)
        with self._lock:
            self._serving[key] = self._serving.get(key, 0) + 1
        try:
            return eng.serve(entry, tokens, **kw)
        finally:
            with self._lock:
                n = self._serving.get(key, 1) - 1
                if n > 0:
                    self._serving[key] = n
                else:
                    self._serving.pop(key, None)
                    pending = self._drop_pending.pop(key, None)
                    if pending is not None:
                        _evict(*pending)

    def _admit(self, model: str, eng: "ServingEngine") -> None:
        while len(self.warm) >= self.max_warm:
            victim = min(self.warm, key=self._amortization)
            dropped = self.warm.pop(victim)
            if self._serving.get(id(dropped), 0) > 0:
                # a thread is mid-serve on the victim: defer the drop to
                # the last in-flight serve's exit
                self._drop_pending[id(dropped)] = (victim, dropped)
            else:
                _evict(victim, dropped)
            self.evictions.append(victim)
            # a re-admitted model must not inherit its old residency's
            # dispatch count, or its amortization starts inflated
            self._dispatches.pop(victim, None)
        # a builder may hand back an engine object evicted earlier
        # (cached builders): cancel its pending drop
        self._drop_pending.pop(id(eng), None)
        self.warm[model] = eng

    def _amortization(self, model: str) -> float:
        """Cold-start seconds this engine saves per dispatch it served --
        low means the warm slot is wasted on it."""
        eng = self.warm[model]
        cold_s = eng.cold_start_s or 0.0
        return cold_s * self._dispatches.get(model, 0)

    # ------------------------------------------------------ adaptive hook
    def shared_hot_components(self, *, min_models: int = 2,
                              util_threshold: float = 0.02) -> list[str]:
        """Component names hot (utilization >= threshold) for at least
        ``min_models`` of the warm engines (the Level-B analogue of the
        fleet's cross-app shared hot set).  A rewarm prewarms them even
        where one engine's own history is thin."""
        from repro_torch.pool.sharing import intersect_hot_sets
        hot_sets = {}
        for model, eng in self.warm.items():
            report = getattr(eng, "report", None)
            if report is None:  # duck-typed engine without utilization
                continue
            rep = report()
            hot_sets[model] = [row["component"]
                               for row in rep["components"]
                               if row["utilization"] >= util_threshold]
        # component names are a flat namespace ("expert.1"/"expert.2"
        # share no loadable parent): exact-name intersection only
        return sorted(intersect_hot_sets(hot_sets,
                                         min_members=min_models,
                                         prefixes=False))

    def rewarm(self, report=None) -> dict:
        """``SlimStartController.rewarm_fn`` hook: re-derive every warm
        engine's :class:`LoadPolicy` from its own live utilization report
        plus the pool's shared hot components, and materialize the new
        set.  ``report`` takes what ``repro_torch.api.artifacts.
        as_report`` accepts (a report object or a saved artifact path):
        it is validated, but Level-B utilization lives in the engines,
        so its contents are not consulted."""
        if report is not None:
            from repro_torch.api.artifacts import as_report
            as_report(report)
        shared = frozenset(self.shared_hot_components())
        out = {}
        for model, eng in self.warm.items():
            policy = LoadPolicy.from_report(eng.report())
            policy = LoadPolicy(
                lazy_groups=policy.lazy_groups,
                lazy_names=policy.lazy_names - shared,
                prewarm=policy.prewarm
                | {c for c in shared if c in eng.registry})
            eng.policy = policy
            eng.registry.materialize_eager(policy)
            out[model] = sorted(policy.prewarm)
        return out

    def stats(self) -> dict:
        total = self.hits + self.misses
        waits = sorted(self.queue_waits_s)
        return {
            "warm_models": sorted(self.warm),
            "shared_hot_components": self.shared_hot_components(),
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": self.hits / max(total, 1),
            "evictions": list(self.evictions),
            "sheds": self.sheds,
            "shed_reasons": ({"pool-saturated": self.sheds}
                             if self.sheds else {}),
            "coalesced": len(self.queue_waits_s),
            "queue_wait_p99_s": (
                waits[min(len(waits) - 1,
                          max(0, round(0.99 * (len(waits) - 1))))]
                if waits else 0.0),
        }


def _drop(eng) -> None:
    """Drop every component of an evicted engine."""
    for comp in eng.registry.values():
        comp.drop()


def _evict(victim: str, eng) -> None:
    """Drop the evicted engine of model ``victim``, under an ``evict``
    span."""
    with get_tracer().span("evict", victim=victim):
        _drop(eng)
