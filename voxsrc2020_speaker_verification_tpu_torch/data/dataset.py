"""Host-side data: feature normalization for extraction and serving, and
the synthetic training feed.

``BatchFeeder`` drains sample iterators into whole optimizer-step batches
((A, B, T, F) features, (A, B) labels) on background threads. Its bf16 wire
is a ``torch.bfloat16`` tensor (the JAX package's is ``ml_dtypes``, which the
port does not use).
"""

from __future__ import annotations

import queue
import threading
from typing import Sequence

import numpy as np
import torch


def sliding_cmn_np(feat: np.ndarray, window: int = 300) -> np.ndarray:
    """Host-side sliding cepstral mean normalization, identical to Kaldi's
    ``apply-cmvn-sliding --norm-vars=false --center=true``. O(T) via one
    float64 cumulative sum."""
    t, f = feat.shape
    csum = np.zeros((t + 1, f), np.float64)
    np.cumsum(feat, axis=0, out=csum[1:])
    ts = np.arange(t)
    start = np.clip(ts - window // 2, 0, max(0, t - window))
    end = np.minimum(start + window, t)
    mean = (csum[end] - csum[start]) / (end - start)[:, None]
    return (feat - mean).astype(np.float32)


class SyntheticDataset:
    """Random (T, F) float32 features in [0, 1) and uniform labels, for
    throughput runs without data (the reference's get_batch_synthetic)."""

    def __init__(self, feat_dim: int, feat_length: int, num_classes: int, seed: int = 0):
        self.feat_dim = feat_dim
        self.feat_length = feat_length
        self.num_classes = num_classes
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        while True:
            yield (
                self.rng.rand(self.feat_length, self.feat_dim).astype(np.float32),
                np.int32(self.rng.randint(self.num_classes)),
            )


class BatchFeeder:
    """Background feeder: one thread per source pushes samples into a
    bounded queue; one thread assembles (A, B, T, F) / (A, B) batches.

    ``wire_bf16`` ships the features as a ``torch.bfloat16`` tensor, half
    the host->device bytes; with bf16 compute it is lossless, since the
    first conv casts its input to bf16 anyway."""

    def __init__(self, sources: Sequence, batch_size: int,
                 num_accumulation_steps: int = 1, queue_depth: int = 2,
                 wire_bf16: bool = False):
        self.wire_bf16 = wire_bf16
        self.sources = list(sources)
        self.batch_size = batch_size
        self.num_accum = num_accumulation_steps
        self.sample_queue: "queue.Queue" = queue.Queue(
            maxsize=max(2, queue_depth) * batch_size * num_accumulation_steps)
        self.batch_queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._threads = []

    def _put(self, q: "queue.Queue", item) -> None:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _pump_source(self, source):
        it = iter(source)
        while not self._stop.is_set():
            try:
                item = next(it)
            except StopIteration:
                return
            self._put(self.sample_queue, item)

    def _assemble(self):
        a, b = self.num_accum, self.batch_size
        while not self._stop.is_set():
            feats, labels = [], []
            while len(feats) < a * b and not self._stop.is_set():
                try:
                    f, l = self.sample_queue.get(timeout=0.5)
                except queue.Empty:
                    continue
                feats.append(f)
                labels.append(l)
            if self._stop.is_set():
                return
            fb = np.stack(feats).reshape(a, b, *feats[0].shape)
            if self.wire_bf16:
                fb = torch.from_numpy(fb).to(torch.bfloat16)
            self._put(self.batch_queue, (fb, np.asarray(labels, np.int32).reshape(a, b)))

    def start(self) -> "BatchFeeder":
        for src in self.sources:
            t = threading.Thread(target=self._pump_source, args=(src,), daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._assemble, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def __iter__(self):
        while True:
            yield self.batch_queue.get()

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
