"""Deterministic sharded data pipeline with background prefetch (a copy of
``repro.training.data`` on the port's ``configs.base``).

Synthetic token streams (per-rank seeded, disjoint) packed to fixed length;
a daemon thread keeps a bounded queue of ready batches so host data work
overlaps device compute (the standard input-pipeline overlap trick).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class TokenStream:
    """Zipf-ish synthetic LM stream; deterministic per (seed, rank)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, rank: int = 0, n_ranks: int = 1):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.rng = np.random.default_rng((seed, rank))
        self.rank, self.n_ranks = rank, n_ranks
        self._step = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        v = self.cfg.vocab_size
        # mixture of a repeating motif and zipf noise -> learnable signal
        base = self.rng.integers(0, v, (self.batch, self.seq + 1),
                                 dtype=np.int32)
        motif = (np.arange(self.seq + 1) * 7 + self._step) % min(v, 97)
        mask = self.rng.random((self.batch, self.seq + 1)) < 0.5
        tokens = np.where(mask, motif[None, :].astype(np.int32), base)
        self._step += 1
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        if self.cfg.is_encdec:
            batch["frames"] = self.rng.normal(
                0, 1, (self.batch, max(self.seq // 2, 4), self.cfg.d_model)
            ).astype(np.float32)
        elif self.cfg.frontend == "vision_patches":
            n = min(self.cfg.n_frontend_tokens, self.seq // 2)
            batch["patches"] = self.rng.normal(
                0, 1, (self.batch, n, self.cfg.d_model)).astype(np.float32)
        return batch


class Prefetcher:
    """Bounded background prefetch queue over a TokenStream.

    A repair of the reference (``repro/training/data.py:59-64``): there a
    put that waits 0.2 s on a full queue drops its batch and draws the
    next, so a consumer slower than that skips batches and the data a run
    sees depends on its step time. Here a batch waits until it is queued
    (or the prefetcher closes), so every consumer sees the stream in order.
    """

    def __init__(self, stream: TokenStream, depth: int = 2):
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self.stream.next_batch()
            try:
                self.q.put(batch, timeout=0.2)
                batch = None
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
