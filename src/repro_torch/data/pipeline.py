"""Deterministic, shard-aware token pipeline: the port's own copy of the
reference's ``data/pipeline.py`` (numpy only), so that the two packages
feed a model the same batches bit for bit.

Properties a 1000-node deployment needs and this implements:
* **Determinism**: batch t is a pure function of (seed, step, shard) — any
  worker can reconstruct any batch, so checkpoint-resume replays exactly and
  elastic re-sharding never duplicates or drops data.
* **Host sharding**: each data-parallel host pulls only its shard
  (``shard_id/num_shards``), indexing into a common stream — no coordinator.
* **Prefetch**: a background thread keeps ``prefetch`` batches ready so the
  accelerator never waits on host-side generation.

The corpus is a seeded Zipfian synthetic stream by default (offline
container); swapping in a real tokenized corpus only changes
``synthetic_corpus`` -> memory-mapped token file.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0
    zipf_a: float = 1.2
    prefetch: int = 2


def synthetic_corpus(cfg: DataConfig, step: int,
                     sample_ids: np.ndarray) -> np.ndarray:
    """Batch of token rows, pure function of (seed, sample_ids).

    Rows mix a Zipfian unigram stream with a deterministic repeated-motif
    structure so language models have actual signal to learn (loss drops
    below the unigram entropy), which the HPO examples rely on."""
    rows = []
    for sid in sample_ids:
        rng = np.random.default_rng((cfg.seed << 20) ^ int(sid))
        z = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1)
        toks = (z - 1) % cfg.vocab_size
        # motif: every row repeats a short pattern => learnable structure
        motif = rng.integers(0, cfg.vocab_size, size=8)
        pos = np.arange(cfg.seq_len + 1)
        use = (pos // 8) % 2 == 0
        toks = np.where(use, motif[pos % 8], toks)
        rows.append(toks)
    return np.stack(rows).astype(np.int32)


class TokenPipeline:
    def __init__(self, cfg: DataConfig,
                 corpus_fn: Callable = synthetic_corpus):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.cfg = cfg
        self.corpus_fn = corpus_fn
        self.local_batch = cfg.global_batch // cfg.num_shards
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ core
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The shard-local batch for a global step (pure, replayable)."""
        base = step * self.cfg.global_batch
        ids = base + self.cfg.shard_id * self.local_batch + np.arange(
            self.local_batch)
        toks = self.corpus_fn(self.cfg, step, ids)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # ------------------------------------------------------------ prefetch
    def start_prefetch(self, from_step: int = 0) -> "TokenPipeline":
        self._q = queue.Queue(maxsize=self.cfg.prefetch)
        self._stop.clear()

        def worker():
            step = from_step
            while not self._stop.is_set():
                batch = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def next_prefetched(self):
        if self._q is None:
            raise RuntimeError("call start_prefetch first")
        return self._q.get()

    def stop_prefetch(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def make_batch_fn(cfg: DataConfig) -> Callable[[int], Dict[str, np.ndarray]]:
    pipe = TokenPipeline(cfg)
    return pipe.batch_at
