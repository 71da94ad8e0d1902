"""Token data pipeline: deterministic synthetic streams + file-backed packed
corpora, with host-side prefetch and checkpointable iterator state.

Determinism & fault tolerance: the stream is a pure function of
(seed, step), so after restart the pipeline resumes exactly at the restored
step — no data skipped/duplicated. Batches are numpy int32 arrays, equal to
the reference pipeline's for the same seed and step; the train step moves
them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic token stream (fast, deterministic, nontrivial):
    mixtures of ngram-cycles so a real model can actually reduce loss."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 n_patterns: int = 64, pattern_len: int = 16):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.patterns = rng.integers(
            0, vocab_size, size=(n_patterns, pattern_len), dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        pid = rng.integers(0, len(self.patterns), size=self.batch)
        off = rng.integers(0, self.patterns.shape[1], size=self.batch)
        idx = (np.arange(self.seq + 1)[None, :] + off[:, None]) % self.patterns.shape[1]
        toks = self.patterns[pid[:, None], idx]
        noise = rng.random(toks.shape) < 0.05
        toks = np.where(noise, rng.integers(0, self.vocab, size=toks.shape), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PackedCorpus:
    """File-backed token corpus (flat .npy of int32 token ids), packed into
    fixed-length rows; step-indexed for deterministic restart."""

    def __init__(self, path: str, batch: int, seq_len: int, seed: int = 0):
        self.tokens = np.load(path, mmap_mode="r")
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.n_rows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        rows = rng.integers(0, self.n_rows, size=self.batch)
        starts = rows * self.seq
        tok = np.stack([self.tokens[s:s + self.seq + 1] for s in starts])
        return {"tokens": tok[:, :-1].astype(np.int32),
                "labels": tok[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch of ``batch_at(step)`` with bounded depth."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch_at(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def next(self):
        s, b = self.q.get()
        self.step = s + 1
        return b

    def close(self):
        """Stops the producer thread and waits for it (it notices within
        its 0.5 s put timeout)."""
        self._stop.set()
        self._thread.join(timeout=5.0)
