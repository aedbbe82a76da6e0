"""Deterministic synthetic data pipeline (sharded, prefetching): a copy of
``repro/training/data.py`` (numpy only), so ``batch_at(step)`` gives the
reference's batches byte for byte.

Two modes:
  * "uniform"  — iid tokens (throughput benchmarking);
  * "markov"   — a fixed random Markov chain over the vocab, so a model can
    actually learn structure (loss visibly decreases in examples).

Determinism: batch(step) depends only on (seed, step), so training resumes
bit-exactly after checkpoint restore — required for fault tolerance.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, mode: str = "markov", order_states: int = 64):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.mode = mode
        if mode == "markov":
            rng = np.random.default_rng(seed + 12345)
            s = min(order_states, vocab_size)
            # sparse-ish transition table: each state prefers ~4 successors
            self.succ = rng.integers(0, vocab_size, size=(s, 4))
            self.states = s

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        if self.mode == "uniform":
            toks = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                                dtype=np.int32)
        else:
            toks = np.empty((self.batch, self.seq + 1), np.int32)
            cur = rng.integers(0, self.states, size=self.batch)
            choice = rng.integers(0, 4, size=(self.batch, self.seq + 1))
            noise = rng.random((self.batch, self.seq + 1)) < 0.05
            rand = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1))
            for t in range(self.seq + 1):
                nxt = self.succ[cur % self.states, choice[:, t]]
                nxt = np.where(noise[:, t], rand[:, t], nxt)
                toks[:, t] = nxt
                cur = nxt
        return toks[:, :-1], toks[:, 1:]

    def iterate(self, start_step: int = 0) -> Iterator:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of host batches (overlap with device step)."""

    def __init__(self, dataset: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            it = dataset.iterate(start_step)
            while not self._stop.is_set():
                try:
                    self.q.put(next(it), timeout=0.5)
                except queue.Full:
                    continue

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def next(self, timeout: float = 30.0):
        return self.q.get(timeout=timeout)

    def stop(self):
        self._stop.set()
