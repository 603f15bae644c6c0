"""Prefetching data pipeline on one device.

* **stateless seeding** — the batch for step t is a pure function of
  (dataset seed, t) (``batch_indices``, a copy of the JAX package's), so
  a restart replays identical batches.
* **host prefetch** — a daemon thread keeps ``PREFETCH`` batches ahead:
  it draws each batch (numpy) and puts it on the device, on a stream of
  its own on a CUDA device, so drawing and copying overlap the step.
  ``wait_s`` adds up the time ``next`` spent waiting for that thread.

``kind="tokens"`` with ``seq_len`` and ``vocab`` draws the LM's motif
sequences (``datasets.synth_tokens_sample``) instead of images.

The mesh of the JAX pipeline (a batch-sharded placement) waits for the
multi-device slice (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch import device as DEV
from repro_torch.data.datasets import DatasetConfig, make_batch


def batch_indices(cfg: DatasetConfig, step: int, batch_size: int,
                  split="train") -> np.ndarray:
    """Deterministic shuffled epoch order, stateless in ``step``."""
    n = cfg.n_train if split == "train" else cfg.n_eval
    epoch = (step * batch_size) // n
    rs = np.random.RandomState((cfg.seed + 17 * epoch) % (2**31 - 1))
    perm = rs.permutation(n)
    start = (step * batch_size) % n
    idx = perm[start:start + batch_size]
    if len(idx) < batch_size:                      # wrap into next epoch
        rs2 = np.random.RandomState((cfg.seed + 17 * (epoch + 1)) % (2**31 - 1))
        idx = np.concatenate([idx, rs2.permutation(n)[:batch_size - len(idx)]])
    return idx


#: batches the data thread keeps ready
PREFETCH = 2


class DataPipeline:
    """``next(pipe) -> (step, x, y)``: the training split's batches from
    ``start_step`` on, x and y tensors on ``device`` (``None`` = the CUDA
    card); ``kind``, ``seq_len`` and ``vocab`` as ``make_batch`` takes
    them."""

    def __init__(self, cfg: DatasetConfig, batch_size: int, *, kind=None,
                 seq_len=None, vocab=None, start_step: int = 0,
                 device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.kind = kind
        self.seq_len = seq_len
        self.vocab = vocab
        self.device = DEV.resolve(device)
        self.step = start_step
        self.wait_s = 0.0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step: int):
        x, y = make_batch(self.cfg,
                          batch_indices(self.cfg, step, self.batch_size),
                          kind=self.kind, seq_len=self.seq_len,
                          vocab=self.vocab)
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        if self._stream is None:
            return x.to(self.device), y.to(self.device), None
        with torch.cuda.stream(self._stream):
            x = x.pin_memory().to(self.device, non_blocking=True)
            y = y.pin_memory().to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        return x, y, ready

    def _producer(self):
        s = self.step
        while not self._stop.is_set():
            item = (s, self._make(s))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    s += 1
                    break
                except queue.Full:
                    continue

    def __next__(self):
        t0 = time.perf_counter()
        step, (x, y, ready) = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            x.record_stream(stream)
            y.record_stream(stream)
        self.step = step + 1
        return step, x, y

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def eval_batches(cfg: DatasetConfig, batch_size: int, *, kind=None,
                 n: int | None = None, seq_len=None, vocab=None):
    """Sequential eval split iterator of numpy batches (no prefetch
    thread)."""
    n = n or cfg.n_eval
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        yield make_batch(cfg, idx, "eval", kind, seq_len, vocab)
