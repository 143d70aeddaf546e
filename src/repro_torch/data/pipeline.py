"""Token data pipeline: deterministic synthetic corpus + prefetching loader
with straggler mitigation (reference: ``repro/data/pipeline.py``; numpy and
threading, so the port keeps its own copy of the same code).

The loader runs sample generation on a worker thread into a bounded queue;
``next_batch(timeout)`` implements BACKUP-SAMPLE substitution: if the worker
misses the deadline (a straggling input shard on a real cluster), the batch
is served from the last known-good batch so the training step never blocks —
the standard trade of determinism for tail latency. Misses are counted for
monitoring.

Behaviours kept as the reference has them: the backup batch when the first
fetch misses is drawn from ``default_rng(0)``, whatever the loader's seed;
the worker retries a full queue every 0.5 s; and a fresh loader replays the
stream from its seed's first batch, so a restarted trainer does not skip
to the step it restored.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic token stream — learnable next-token structure."""

    def __init__(self, vocab: int, seq_len: int, seed: int = 0,
                 n_states: int = 64):
        self.vocab = vocab
        self.seq_len = seq_len
        rng = np.random.default_rng(seed)
        self.trans = rng.integers(0, vocab, size=(n_states, 8))
        self.n_states = n_states

    def sample(self, rng: np.random.Generator, batch: int) -> dict:
        state = rng.integers(0, self.n_states, size=batch)
        toks = np.empty((batch, self.seq_len + 1), np.int32)
        for t in range(self.seq_len + 1):
            choice = rng.integers(0, 8, size=batch)
            toks[:, t] = self.trans[state, choice]
            state = (state * 31 + toks[:, t]) % self.n_states
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class PrefetchLoader:
    def __init__(self, source: SyntheticLM, batch: int, seed: int = 0,
                 prefetch: int = 2, timeout_s: float = 10.0):
        self.source = source
        self.batch = batch
        self.timeout_s = timeout_s
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._rng = np.random.default_rng(seed)
        self._last_good: Optional[dict] = None
        self.straggler_misses = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            b = self.source.sample(self._rng, self.batch)
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next_batch(self) -> dict:
        try:
            b = self._q.get(timeout=self.timeout_s)
            self._last_good = b
            return b
        except queue.Empty:
            # straggler mitigation: serve the backup batch instead of stalling
            self.straggler_misses += 1
            if self._last_good is None:
                b = self.source.sample(np.random.default_rng(0), self.batch)
                self._last_good = b
            return self._last_good

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
