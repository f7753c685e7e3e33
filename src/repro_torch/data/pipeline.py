"""Deterministic synthetic token pipeline with exact restart semantics.

Design goals (what a real fleet needs, scaled to this container):
  * stateless addressing — batch contents are a pure function of
    (seed, step, host_index), so skip-ahead restart after a failure is
    exact and free (no stream replay);
  * per-host sharding — each host generates only its slice of the global
    batch (``host_index``/``num_hosts``);
  * background prefetch — a double-buffered thread keeps the accelerator
    fed (overlap of input pipeline with compute).

Token statistics are Zipf-like (power-law over the vocab) so losses and
router load-balance behave like text rather than uniform noise.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide by num_hosts")
        return self.global_batch // self.num_hosts


class SyntheticStream:
    """Iterator of {"tokens","labels"} int32 [host_batch, seq_len]."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        # precompute the Zipf CDF once
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** -cfg.zipf_a
        self._cdf = np.cumsum(w / w.sum())

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        u = rng.random((cfg.host_batch, cfg.seq_len + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, cfg.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def skip_to(self, step: int) -> None:
        """Exact restart: next batch will be ``batch_at(step)``."""
        self.step = step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}


class Prefetcher:
    """Double-buffered background prefetch over any dict iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
