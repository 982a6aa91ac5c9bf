"""Host data pipeline: deterministic, seekable, prefetching (a copy of
``repro/data/pipeline.py``, numpy only, so one seed gives the JAX
package's tokens).

Determinism/seekability is the fault-tolerance property: batch indices are
a pure function of (seed, step), so a restarted job resumes mid-epoch on
exactly the batch it would have seen — no replayed or skipped data after
an elastic restart, even at a different data-parallel size.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


def batch_indices(n_items: int, batch: int, step: int, seed: int) -> np.ndarray:
    """Indices of global batch `step` under per-epoch shuffling."""
    steps_per_epoch = n_items // batch
    epoch = step // steps_per_epoch
    within = step % steps_per_epoch
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    perm = rng.permutation(n_items)
    return perm[within * batch: (within + 1) * batch]


class TokenStream:
    """Synthetic LM token stream (offline surrogate for a real corpus).

    Tokens follow a deterministic mixture of  zipfian unigrams and a
    repeated-ngram process, so models have actual structure to learn.
    """

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int, batch: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        toks = rng.choice(self.vocab, size=(batch, seq_len), p=self._probs)
        # overlay repeated n-grams (learnable bigram structure)
        ngram = rng.choice(self.vocab, size=16, p=self._probs)
        pos = rng.integers(0, max(1, seq_len - 16), size=batch)
        for b in range(batch):
            if rng.random() < 0.5:
                toks[b, pos[b]: pos[b] + 16] = ngram
        return toks.astype(np.int32)


class Prefetcher:
    """Background-thread prefetch of host batches (depth-bounded queue)."""

    def __init__(self, make_batch: Callable[[int], object], start_step: int,
                 depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def next(self) -> Tuple[int, object]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
