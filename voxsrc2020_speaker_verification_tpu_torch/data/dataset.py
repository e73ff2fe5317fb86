"""Host-side data: feature normalization for extraction and serving, the
feature-shard training dataset and the synthetic training feed.

``FeatureShardDataset`` streams (feature crop, label) samples from one scp
shard of a Kaldi feature store with the reference's semantics (the JAX
package's ``data/dataset.py``): an endless pass with a random ~10% skip on
every pass, sliding CMN over the whole utterance, optional global CMVN,
then a random crop (or a randomly shifted zero pad). ``BatchFeeder`` drains
sample iterators into whole optimizer-step batches ((A, B, T, F) features,
(A, B) labels, or raw-audio tuples) on background threads. Its bf16 wire
is a ``torch.bfloat16`` tensor (the JAX package's is ``ml_dtypes``, which
the port does not use).
``data/native.py:NativeBatchFeeder`` does the same work in C++.
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kaldi_io


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


class FeatureCropper:
    """The reference's crop policy: a random ``feat_length`` window of a
    long utterance, or a short one zero-padded at a random shift."""

    def __init__(self, feat_length: int, feat_dim: int, rng: np.random.RandomState):
        self.feat_length = feat_length
        self.feat_dim = feat_dim
        self.rng = rng

    def __call__(self, feat: np.ndarray) -> np.ndarray:
        t = self.feat_length
        if feat.shape[0] < t:
            out = np.zeros((t, self.feat_dim), np.float32)
            shift = self.rng.randint(t - feat.shape[0] + 1)
            out[shift: shift + feat.shape[0]] = feat
            return out
        shift = self.rng.randint(feat.shape[0] - t + 1)
        return np.ascontiguousarray(feat[shift: shift + t], dtype=np.float32)


class FeatureShardDataset:
    """Endless (feature, label) stream over one scp shard of precomputed
    features. Training mode skips ~``skip_percent``% of the utterances at
    random on every pass (the reference's reshuffle) and crops; eval mode
    makes one pass and yields whole utterances. The RNG (skips and crops) is
    ``np.random.RandomState(seed)``, as in the JAX package, so both give the
    same samples from the same seed."""

    def __init__(self, scp_path: str, utt2id: Dict[str, int], feat_dim: int,
                 feat_length: int, cmvn_pkl: Optional[str] = None, training: bool = True,
                 skip_percent: int = 10, seed: int = 0, sliding_cmn: bool = True,
                 cmn_window: int = 300):
        self.scp_path = scp_path
        self.utt2id = utt2id
        self.feat_dim = feat_dim
        self.feat_length = feat_length
        self.training = training
        self.skip_percent = skip_percent
        self.sliding_cmn = sliding_cmn
        self.cmn_window = cmn_window
        self.rng = np.random.RandomState(seed)
        self.mean, self.std = (None, None)
        if cmvn_pkl:
            with open(cmvn_pkl, "rb") as f:
                self.mean, self.std = pickle.load(f)
        self.cropper = FeatureCropper(feat_length, feat_dim, self.rng)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.int32]]:
        gen = kaldi_io.read_mat_scp(self.scp_path)
        while True:
            try:
                utt, feat = next(gen)
                if self.training and self.rng.randint(0, 100) >= 100 - self.skip_percent:
                    continue
            except StopIteration:
                if not self.training:
                    return
                gen = kaldi_io.read_mat_scp(self.scp_path)
                utt, feat = next(gen)
            if self.sliding_cmn:
                # over the whole utterance, before the crop, as the
                # reference's apply-cmvn-sliding feeder pipe
                feat = sliding_cmn_np(feat, self.cmn_window)
            if self.mean is not None:
                feat = (feat - self.mean) / self.std
            if self.training:
                feat = self.cropper(feat)
            yield feat, (np.int32(self.utt2id[utt]) if self.utt2id else utt)


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


class RowBlock:
    """Rows [start, stop) of every microbatch of another feeder's (A, B, ...)
    batches: one data rank's block of a global batch that every rank draws
    alike (``cli/train.py --synthetic`` across processes)."""

    def __init__(self, feeder, start: int, stop: int):
        self.feeder, self.start, self.stop_row = feeder, start, stop

    def __iter__(self):
        rows = slice(self.start, self.stop_row)
        for feats, labels in self.feeder:
            if isinstance(feats, tuple):
                yield (tuple(np.ascontiguousarray(x[:, rows]) for x in feats),
                       np.ascontiguousarray(labels[:, rows]))
            else:
                yield np.ascontiguousarray(feats[:, rows]), np.ascontiguousarray(labels[:, rows])

    def stop(self):
        self.feeder.stop()


class BatchFeeder:
    """Background feeder: one thread per source pushes samples into a
    bounded queue; one thread assembles (A, B, T, F) / (A, B) batches.
    Raw-audio samples (``data/raw_dataset.py``: a tuple of wave int16,
    num_samples, target_offset and pad_shift) assemble field by field into
    a tuple of (A, B, ...) arrays.

    ``wire_bf16`` ships the features as a ``torch.bfloat16`` tensor, half
    the host->device bytes; with bf16 compute it is lossless, since the
    first conv casts its input to bf16 anyway. Raw batches have no bf16
    wire (their waves are int16 already)."""

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
            if isinstance(feats[0], tuple):
                # raw-audio samples: one (A, B, ...) array a field
                fb = tuple(np.stack([f[k] for f in feats]).reshape(a, b, *np.shape(feats[0][k]))
                           for k in range(len(feats[0])))
            else:
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


def shard_paths_for_host(data_dir: str, total_shards: int, host_index: int,
                         num_hosts: int) -> list:
    """The ``{N}-split/feats.{i}.scp`` shards a host owns: a contiguous
    block of ``total_shards / num_hosts`` (the reference's per-rank split)."""
    if total_shards % num_hosts:
        raise ValueError(f"{total_shards} shards do not split over {num_hosts} hosts")
    per_host = total_shards // num_hosts
    return [f"{data_dir}/{total_shards}-split/feats.{i + 1}.scp"
            for i in range(per_host * host_index, per_host * (host_index + 1))]
