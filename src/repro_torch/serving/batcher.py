"""Continuous batching over a slot-based decode batch (PyTorch port of
``repro.serving.batcher``).

Requests arrive asynchronously; each is prefilled (batch 1) into a free
slot of the shared decode batch, and one ``decode_fn`` step advances all
slots together.  Finished slots free immediately (continuous batching a
la Orca/vLLM, slot-static variant for fixed shapes).

Unlike the reference, which rebuilds its immutable cache tree, the port
splices a prefill into its slot in place (``splice_batch_axis``), so the
cache tree keeps its addresses and a CUDA graph of the decode step
(``graphs.DecodeGraph``, whose static caches are the batcher's) can
drive it.  Token and position arrays stay numpy on the host, as in the
reference; a step's (S, 1) output is the one tensor that comes back.

Also hosts the serving-side straggler guard: a per-step deadline; steps
that exceed it are counted and surface in the batcher stats.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # (prompt_len,)
    max_new_tokens: int
    arrival_s: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    finish_s: Optional[float] = None

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class ContinuousBatcher:
    """Drives (prefill_fn, decode_fn) over a fixed slot count.

    prefill_fn(tokens (1, L) int32) -> (first_token (1,), caches_b1)
    decode_fn(token (S, 1), pos (S,), caches) -> (next (S, 1), caches)
    where S = n_slots.  Cache leaves are (layer_stack, batch, ...), on
    the device the tokens are sent to.
    """

    def __init__(self, prefill_fn, decode_fn, init_caches, *,
                 n_slots: int, eos_token: Optional[int] = None,
                 step_deadline_s: float = 5.0):
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.caches = init_caches
        self.device = next(_leaves(init_caches)).device
        self.n_slots = n_slots
        self.eos = eos_token
        self.deadline = step_deadline_s
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)
        self.cur = np.zeros(n_slots, np.int32)
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.slow_steps = 0
        self.steps = 0

    # ------------------------------------------------------------ admin
    def submit(self, req: Request):
        req.arrival_s = req.arrival_s or time.perf_counter()
        self.queue.append(req)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _device(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32), device=self.device)

    # ------------------------------------------------------------- step
    def _admit(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.queue.popleft()
            first, caches_1 = self.prefill_fn(self._device(req.tokens[None]))
            splice_batch_axis(self.caches, caches_1, slot)
            self.slots[slot] = req
            tok = int(first.reshape(-1)[0])
            req.out_tokens.append(tok)
            self.cur[slot] = tok
            self.pos[slot] = len(req.tokens)

    def step(self) -> int:
        """Admit waiting requests, run one decode step; returns number of
        tokens produced."""
        self._admit()
        if self.active == 0:
            return 0
        t0 = time.perf_counter()
        nxt, self.caches = self.decode_fn(self._device(self.cur[:, None]),
                                          self._device(self.pos),
                                          self.caches)
        nxt = nxt.cpu().numpy().reshape(-1)
        dt = time.perf_counter() - t0
        self.steps += 1
        if dt > self.deadline:
            self.slow_steps += 1
        produced = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.out_tokens.append(int(nxt[i]))
            self.cur[i] = int(nxt[i])
            self.pos[i] += 1
            produced += 1
            if req.done or (self.eos is not None
                            and int(nxt[i]) == self.eos):
                req.finish_s = time.perf_counter()
                self.finished.append(req)
                self.slots[i] = None
        return produced

    def run_until_drained(self, max_steps: int = 10_000):
        while (self.queue or self.active) and max_steps > 0:
            self.step()
            max_steps -= 1
        return self.stats()

    def stats(self) -> dict:
        lat = [r.finish_s - r.arrival_s for r in self.finished
               if r.finish_s]
        return {
            "finished": len(self.finished),
            "steps": self.steps,
            "slow_steps": self.slow_steps,
            "mean_latency_s": float(np.mean(lat)) if lat else None,
            "p99_latency_s": float(np.percentile(lat, 99)) if lat else
            None,
        }


def splice_batch_axis(tree_full, tree_one, slot: int):
    """Write batch entry ``slot`` of tree_full from tree_one (batch 1),
    in place; cache leaves are (layer_stack, batch, ...).  Returns
    tree_full, whose leaves keep their addresses."""
    for k, full in tree_full.items():
        one = tree_one[k]
        if isinstance(full, dict):
            splice_batch_axis(full, one, slot)
        else:
            full[:, slot].copy_(one[:, 0])
    return tree_full
