"""One decode step captured as a CUDA graph (port-only).

The reference compiles each entry's decode step ahead of time
(``jax.jit(decode_fn).lower(...).compile()``): one executable for the
step, built at cold start.  The port's counterpart is a CUDA graph of
the eager step, captured once at the engine's fixed shapes: a replay
issues the step's hundreds of kernels (the hand-written
``decode_attention`` among them) with one launch from the host.

A graph reads and writes fixed addresses, so ``DecodeGraph`` owns them:
the token (B, 1) and position (B,) inputs, the cache tree (static: a
request's prefill is written into it, ``model.prefill(caches=)``), the
outputs (next token and logits) and, in the graph's private memory
pool, every intermediate.  Calls replay into those same buffers, so a
graph serves one request at a time.

Three things the capture takes care of:

* ``decode_attention``'s scratch (ticket counters and partials) is kept
  per (device, stream) and grows on demand.  The warm-up runs on the
  capture stream, so it grows that stream's set to the most any layer
  asks; the capture then allocates nothing, and the graph takes the set
  over (no other call finds it again).  The kernel leaves the tickets
  at 0, so every replay reuses them.  Each graph owns its own set.
* The kernel wrappers count launches in Python.  During the capture
  they count kernels that do not run; during a replay no Python runs.
  The graph records each counter's increase over the capture, takes it
  back, and adds it on every replay, so the counts stay exact (as long
  as no other thread launches kernels while a capture is underway).
* Nothing in the step may sync with the host (``model._check_range``
  asserts on the device).  A capture that fails raises; nothing falls
  back to the eager step.

Only one capture may be underway in a process (CUDA's and PyTorch's
rule); ``_CAPTURE_LOCK`` serializes the engines that build in parallel
threads, and the capture runs in ``thread_local`` mode so other
threads' work does not break it.
"""

from __future__ import annotations

import threading
import time

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  take_scratch)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_decode import moe_decode
from repro_torch.kernels.rglru_scan import rglru_scan

# the kernel wrappers whose ``launches`` a replay adds to
COUNTED = (flash_attention, decode_attention, rglru_scan, moe_decode)
_CAPTURE_LOCK = threading.Lock()


class DecodeGraph:
    """``step_fn(params, tok, pos, caches) -> (logits, caches)`` captured
    once with ``params`` and the static ``caches`` (updated in place by
    the step).

    ``graph(tok, pos)`` copies the inputs into the static buffers (``tok``
    (B, 1) int32 tensor; ``pos`` (B,) int32 tensor or one int for every
    row), replays, and returns the static ``(next_tok (B, 1) int32,
    logits (B, V) fp32)``, overwritten by the next call: no host sync.
    ``capture_s`` is the warm-up and capture's wall time.
    """

    def __init__(self, step_fn, params, caches, batch: int, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"DecodeGraph: no CUDA graph on {device}")
        t0 = time.perf_counter()
        # the graph reads the parameters by address: keep them alive
        self.params, self.caches = params, caches
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.graph = torch.cuda.CUDAGraph()

        def step():
            logits, _ = step_fn(params, self.tok, self.pos, caches)
            return logits.argmax(dim=-1).to(torch.int32)[:, None], logits

        with _CAPTURE_LOCK:
            capture = torch.cuda.graph(self.graph,
                                       capture_error_mode="thread_local")
            side = capture.capture_stream
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                step()  # warm-up: real launches, counted as such
            n0 = [f.launches for f in COUNTED]
            with capture:
                self.next_tok, self.logits = step()
            self._launches = [(f, f.launches - n) for f, n in zip(COUNTED,
                                                                   n0)]
            for f, n in self._launches:
                f.launches -= n  # captured, not launched
            self._scratch = take_scratch(device, side.cuda_stream)
        torch.cuda.current_stream(device).wait_stream(side)
        for t in self._scratch or ():
            # replays run on the caller's stream: the allocator must not
            # hand the set out again before they finish
            t.record_stream(torch.cuda.current_stream(device))
        self.capture_s = time.perf_counter() - t0

    def launches(self) -> dict[str, int]:
        """Kernel launches one replay makes, by wrapper name."""
        return {f.__name__: n for f, n in self._launches}

    def __call__(self, tok, pos):
        self.tok.copy_(tok)
        if isinstance(pos, int):
            self.pos.fill_(pos)
        else:
            self.pos.copy_(pos)
        self.graph.replay()
        for f, n in self._launches:
            f.launches += n
        return self.next_tok, self.logits
