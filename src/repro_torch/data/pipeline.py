"""Token data pipeline: a synthetic dataset, a sharded loader with a
background prefetch thread, and a batch function for tests.

The port's own copy of the reference's ``repro/data/pipeline.py`` (numpy
only there too), so that the same seed gives the same tokens in both
packages:

* ``SyntheticLMDataset``: a deterministic pseudo-corpus (Zipfian unigrams
  and short-range repeats), so that a loss falls without external data;
* ``ShardedLoader``: shard i of n reads interleaved windows; a prefetch
  thread fills a bounded queue; a (step) cursor travels in checkpoints so a
  resumed run continues the stream exactly. A prefetch timeout marks the
  batch late (the straggler signal ``train/loop.py`` reports). The thread
  starts at the first ``next`` and stops at ``close()``, which every owner
  must call (``train_loop`` does).

Batches are numpy arrays: {"tokens": (B, S) int32, "labels": (B, S) int32}.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


class SyntheticLMDataset:
    """Infinite deterministic token stream with learnable structure."""

    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.3):
        self.vocab = vocab_size
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** zipf_a
        self.p = p / p.sum()

    def window(self, index: int, length: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        toks = rng.choice(self.vocab, size=length + 1, p=self.p)
        # short-range structure: every even position repeats the previous
        # token with p=.5 (a pattern a model can learn)
        mask = (np.arange(length + 1) % 2 == 0) & (rng.random(length + 1) < .5)
        toks[1:][mask[1:]] = toks[:-1][mask[1:]]
        return toks.astype(np.int32)


@dataclass
class LoaderState:
    step: int = 0

    def to_dict(self):
        return {"step": int(self.step)}

    @staticmethod
    def from_dict(d):
        return LoaderState(int(d.get("step", 0)))


class ShardedLoader:
    """Yields {tokens, labels} host batches for shard `shard`/`n_shards`."""

    def __init__(self, dataset, batch_per_shard: int, seq_len: int,
                 shard: int = 0, n_shards: int = 1, prefetch: int = 2,
                 state: Optional[LoaderState] = None,
                 timeout_s: float = 30.0):
        self.ds = dataset
        self.B = batch_per_shard
        self.S = seq_len
        self.shard = shard
        self.n_shards = n_shards
        self.state = state or LoaderState()
        self.timeout_s = timeout_s
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        # the worker starts lazily on the first __next__, so that a cursor
        # restored from a checkpoint (set after construction) takes effect
        self._thread: Optional[threading.Thread] = None
        self.late_batches = 0

    def _global_index(self, step: int, row: int) -> int:
        # global sample index: the same whatever the shard count
        return step * (self.B * self.n_shards) + self.shard * self.B + row

    def _make(self, step: int):
        toks = np.stack([self.ds.window(self._global_index(step, r), self.S)
                         for r in range(self.B)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _worker(self):
        step = self.state.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.25)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        t0 = time.monotonic()
        try:
            step, batch = self._q.get(timeout=self.timeout_s)
        except queue.Empty:
            # a stuck shard yields a repeat of the last-known-good index
            # rather than stalling
            self.late_batches += 1
            batch = self._make(self.state.step)
            step = self.state.step
        self.state.step = step + 1
        if time.monotonic() - t0 > self.timeout_s * 0.5:
            self.late_batches += 1
        return batch

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


def make_batch_fn(vocab: int, batch: int, seq: int, seed: int = 0):
    """step -> batch dict, the loader's batch of that step (one shard)."""
    ds = SyntheticLMDataset(vocab, seed)

    def fn(step: int):
        toks = np.stack([ds.window(step * batch + r, seq)
                         for r in range(batch)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return fn
