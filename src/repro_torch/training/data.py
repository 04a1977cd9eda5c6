"""Deterministic synthetic data pipeline (the port's own copy of
``repro.training.data``, which imports no JAX: the same seed gives the
same tokens in both packages).

A seeded token stream (mixture of Zipf-distributed unigrams and
repeated n-gram "phrases" so a real LM loss signal exists), packed into
fixed-length training sequences, with an async double-buffered host
prefetcher — the structure of a production input pipeline without an
external dataset dependency.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticCorpus:
    """Zipf unigrams + phrase bank => learnable next-token structure."""

    def __init__(self, vocab: int, seed: int = 0, phrase_bank: int = 512,
                 phrase_len: int = 8, phrase_prob: float = 0.5):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.phrases = self.rng.integers(
            0, vocab, (phrase_bank, phrase_len))
        self.phrase_prob = phrase_prob
        # Zipf over the vocab, renormalized
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.p = 1.0 / ranks
        self.p /= self.p.sum()

    def tokens(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        i = 0
        while i < n:
            if self.rng.random() < self.phrase_prob:
                ph = self.phrases[self.rng.integers(len(self.phrases))]
                m = min(len(ph), n - i)
                out[i:i + m] = ph[:m]
                i += m
            else:
                m = min(int(self.rng.integers(4, 16)), n - i)
                out[i:i + m] = self.rng.choice(
                    self.vocab, size=m, p=self.p)
                i += m
        return out


def packed_batches(corpus: SyntheticCorpus, batch: int, seq: int
                   ) -> Iterator[dict]:
    """Yields {"tokens": (B, S), "labels": (B, S)} next-token pairs."""
    while True:
        flat = corpus.tokens(batch * (seq + 1))
        arr = flat.reshape(batch, seq + 1)
        yield {"tokens": arr[:, :-1].copy(),
               "labels": arr[:, 1:].copy()}


class Prefetcher:
    """Host-side async prefetch (double buffering) over an iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_pipeline(vocab: int, batch: int, seq: int, *, seed: int = 0,
                  prefetch: int = 2) -> Iterator[dict]:
    corpus = SyntheticCorpus(vocab, seed=seed)
    return Prefetcher(packed_batches(corpus, batch, seq), depth=prefetch)
