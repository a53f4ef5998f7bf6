"""Shard-aware token data pipeline with prefetch and resumable state
(copy of `repro.data.pipeline`, numpy only).

Sources: synthetic (deterministic per (seed, step) — reproducible across
restarts without any data-state checkpointing beyond the step counter) or
a binary int32 token file (`np.memmap`).  Each data-parallel host reads
only its shard: `shard_id/num_shards` stride over the sequence stream.
Batches are numpy int32 arrays `[batch, seq + 1]`, bitwise the
reference's; the training launcher moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class PipelineConfig:
    batch: int                  # per-host batch
    seq: int
    vocab: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    token_file: Optional[str] = None
    prefetch: int = 2


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.step = 0
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- deterministic batch construction (resumable) ---
    def _batch_at(self, step: int) -> np.ndarray:
        c = self.cfg
        if self._mm is not None:
            tokens_per_batch = c.batch * (c.seq + 1)
            stride = tokens_per_batch * c.num_shards
            start = (step * stride + c.shard_id * tokens_per_batch) % \
                max(1, len(self._mm) - tokens_per_batch)
            flat = np.asarray(self._mm[start:start + tokens_per_batch])
            return flat.reshape(c.batch, c.seq + 1).astype(np.int32)
        rng = np.random.default_rng((c.seed, step, c.shard_id))
        # zipf-ish synthetic distribution: heavy-tailed like text
        z = rng.zipf(1.3, size=(c.batch, c.seq + 1))
        return np.minimum(z, c.vocab - 1).astype(np.int32)

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = {"tokens": self._batch_at(step)}
            self._q.put((step, batch))
            step += 1

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self) -> Iterator[dict]:
        if self._thread is None:
            # synchronous fallback
            while True:
                yield {"tokens": self._batch_at(self.step)}
                self.step += 1
        else:
            while True:
                step, batch = self._q.get()
                self.step = step + 1
                yield batch

    # --- checkpointable state ---
    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, s):
        self.step = int(s["step"])
