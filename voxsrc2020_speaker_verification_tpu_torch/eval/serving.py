"""Production embedding serving: dynamic batching over static-shape buckets.

The offline extraction design -- length buckets + masked pooling +
reference-exact 1000-frame chunk averaging (eval/extract.py) -- with a
request plane on top:

* concurrent ``embed`` requests are chunked, routed to per-bucket queues,
  and flushed as full ``batch_size`` batches;
* a flush also fires when the oldest queued chunk exceeds ``max_wait_ms``,
  so a lone request still completes promptly (partial batches are padded to
  the full batch);
* all device work of the model runs on one batcher thread; callers block on
  events.

Front-end work runs in the calling thread: FBANK for wave requests on the
device (K1, ``ops/fbank.py``), then full-utterance sliding CMVN on the host.

Verification scoring: cosine on l2-normalized embeddings, with optional
adaptive s-norm against the artifact's exported projection-weight cohort
(the classifier rows double as cohort speakers).
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from .extract import (
    MAX_FRAMES, MIN_FRAMES, chunk_spans, default_batch_size,
    pack_chunk_batch, resolve_wire_dtype, select_bucket, to_numpy,
)
from .scoring import l2norm

# Serving caps: requests past them are rejected with a clear error -- a
# client with longer audio chunks it client-side. ~10.9 min of features,
# 128 s of raw audio per request.
_CMVN_BUCKETS = (500, 1000, 2000, 4000, 8000, 16000, 32000, 65536)
_WAVE_BUCKET_SECONDS = (2, 4, 8, 16, 32, 64, 128)


class _Request:
    """One utterance embedding in flight: chunk accumulator + completion."""

    __slots__ = ("acc", "weight", "remaining", "event", "error", "cancelled")

    def __init__(self, num_chunks: int):
        self.acc = 0.0
        self.weight = 0.0
        self.remaining = num_chunks
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.cancelled = False

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.event.wait(timeout):
            # orphaned chunks still queued are dropped at the next flush
            # selection instead of burning device batches for no waiter
            self.cancelled = True
            raise TimeoutError("embedding request timed out")
        if self.error is not None:
            raise self.error
        return (self.acc / self.weight).astype(np.float32)


class EmbeddingService:
    """Thread-safe embedding + verification service over an inference
    artifact (eval/export.py) on ``device`` (default ``cuda``)."""

    def __init__(
        self,
        artifact_dir: str,
        *,
        batch_size: Optional[int] = None,
        buckets: Sequence[int] = (256, 512, 1000),
        max_wait_ms: float = 10.0,
        cmn_window: int = 300,
        request_timeout: float = 600.0,
        wire: str = "float32",
        device: Optional[Union[str, torch.device]] = None,
    ):
        from .export import load_inference_artifact
        from .extract import make_bucketed_embed_fn

        self.device = resolve_device(device)
        self.config, embed = load_inference_artifact(artifact_dir, self.device)
        self.batch_size = batch_size or default_batch_size(self.config.model)
        self._embed = make_bucketed_embed_fn(embed, batch_size=self.batch_size)
        self._wire_dtype = resolve_wire_dtype(wire)
        self.buckets = sorted(set(list(buckets) + [MAX_FRAMES]))
        self.max_wait = max_wait_ms / 1000.0
        self.cmn_window = cmn_window
        self.request_timeout = request_timeout

        cohort_pkl = os.path.join(artifact_dir, "projection_weight.pkl")
        self._cohort: Optional[np.ndarray] = None
        if os.path.exists(cohort_pkl):
            with open(cohort_pkl, "rb") as f:
                self._cohort = np.asarray(pickle.load(f), np.float32)

        # bucket -> [(request, length, (length, F) chunk, enqueue time), ...]
        # FIFO per bucket: entry 0 is always the oldest.
        self._pending: Dict[
            int, List[Tuple[_Request, int, np.ndarray, float]]] = {
            b: [] for b in self.buckets
        }
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = False
        self.num_requests = 0
        self.num_flushes = 0
        self._thread = threading.Thread(
            target=self._batcher, name="embed-batcher", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # request plane
    # ------------------------------------------------------------------

    def submit_features(self, feats: np.ndarray, cmvn: bool = True) -> _Request:
        """Queue one utterance, (T, F) float32 features -> request handle.
        ``cmvn`` applies full-utterance sliding CMVN first."""
        feats = np.ascontiguousarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.config.feat_dim:
            raise ValueError(
                f"features must be (T, {self.config.feat_dim}); got {feats.shape}")
        if cmvn:
            feats = self._cmvn(feats)
        spans = chunk_spans(len(feats), MAX_FRAMES, MIN_FRAMES)
        req = _Request(len(spans))
        with self._cv:
            if self._stop:
                raise RuntimeError("service is closed")
            self.num_requests += 1
            now = time.monotonic()
            for start, length in spans:
                b = select_bucket(self.buckets, length, MAX_FRAMES)
                self._pending[b].append(
                    (req, length, feats[start: start + length], now))
            self._cv.notify()
        return req

    def embed_features(self, feats: np.ndarray, cmvn: bool = True,
                       timeout: Optional[float] = None) -> np.ndarray:
        return self.submit_features(feats, cmvn=cmvn).result(
            self.request_timeout if timeout is None else timeout)

    def embed_wave(self, wave: np.ndarray, cmvn: bool = True,
                   timeout: Optional[float] = None) -> np.ndarray:
        """Embed raw 16 kHz audio (int16 scale). FBANK runs on the device
        with dither off, then the feature path above."""
        return self.submit_wave(wave, cmvn=cmvn).result(
            self.request_timeout if timeout is None else timeout)

    def submit_wave(self, wave: np.ndarray, cmvn: bool = True) -> _Request:
        return self.submit_features(self.features_from_wave(wave), cmvn=cmvn)

    def warmup(self, timeout: Optional[float] = None) -> None:
        """Run every serving shape once up front: one embed per length bucket
        at the padded batch, and one FBANK. This builds (or loads) the CUDA
        kernels and settles the library's per-shape choices before the first
        request."""
        reqs = [self.submit_features(
                    np.zeros((b, self.config.feat_dim), np.float32),
                    cmvn=False)
                for b in self.buckets]
        for r in reqs:
            r.result(self.request_timeout if timeout is None else timeout)
        self.features_from_wave(np.zeros(_WAVE_BUCKET_SECONDS[0] * 16000, np.float32))

    # ------------------------------------------------------------------
    # scoring plane
    # ------------------------------------------------------------------

    def score(self, emb_a: np.ndarray, emb_b: np.ndarray,
              asnorm: bool = False, topk: int = 400) -> float:
        """Verification score of two embeddings: cosine of l2-normed vectors;
        ``asnorm`` z-norms each side against its top-k scores vs the
        artifact's projection-weight cohort."""
        a = l2norm(np.asarray(emb_a, np.float64))
        b = l2norm(np.asarray(emb_b, np.float64))
        s = float(np.dot(a, b))
        if not asnorm:
            return s
        if self._cohort is None:
            raise ValueError("artifact has no projection_weight.pkl cohort")
        # k >= 2: a top-1 "distribution" has std 0 (division blows up), and
        # topk <= 0 would silently slice the whole cohort via [-0:]
        k = min(topk, len(self._cohort))
        if k < 2:
            raise ValueError(
                f"asnorm needs topk >= 2 within the cohort "
                f"(topk={topk}, cohort={len(self._cohort)})")
        stats = []
        for v in (a, b):
            scores = self._cohort @ v.astype(np.float32)
            top = np.partition(scores, -k)[-k:].astype(np.float64)
            sd = top.std()
            if sd == 0.0:
                raise ValueError("degenerate cohort: top-k scores have "
                                 "zero variance")
            stats.append((top.mean(), sd))
        (m1, s1), (m2, s2) = stats
        return float(0.5 * ((s - m1) / s1 + (s - m2) / s2))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _cmvn(self, feats: np.ndarray) -> np.ndarray:
        """Full-utterance sliding CMVN on the host (``sliding_cmn_np``,
        Kaldi-exact). The cap bounds per-request memory."""
        from ..data.dataset import sliding_cmn_np

        t = len(feats)
        if t > _CMVN_BUCKETS[-1]:
            raise ValueError(
                f"utterance of {t} frames exceeds the serving cap "
                f"({_CMVN_BUCKETS[-1]} frames); chunk it client-side")
        return sliding_cmn_np(feats, self.cmn_window)

    def features_from_wave(self, wave: np.ndarray) -> np.ndarray:
        """(S,) int16-scale audio -> (T, F) log-mel features: PCM16
        quantization on the host, FBANK on the device."""
        from ..ops.fbank import FbankConfig, fbank, pcm16

        cfg = FbankConfig(num_bins=self.config.feat_dim, dither=0.0)
        n = len(wave)
        if n > _WAVE_BUCKET_SECONDS[-1] * cfg.sample_rate:
            raise ValueError(
                f"wave of {n} samples exceeds the serving cap "
                f"({_WAVE_BUCKET_SECONDS[-1]} s); chunk it client-side")
        pcm = torch.from_numpy(pcm16(np.asarray(wave, np.float32)).astype(np.int16))
        with torch.inference_mode():
            feats = fbank(pcm.to(self.device).float(), cfg)
        return to_numpy(feats)

    def _batcher(self):
        while True:
            with self._cv:
                batch, bucket = None, None
                while batch is None:
                    now = time.monotonic()
                    deadline = None
                    for b in self.buckets:
                        q = self._pending[b]
                        # timed-out requests' chunks are dropped here, not
                        # flushed: no device batches for abandoned waiters
                        if any(e[0].cancelled for e in q):
                            q[:] = [e for e in q if not e[0].cancelled]
                        if not q:
                            continue
                        age = now - q[0][3]
                        if len(q) >= self.batch_size or age >= self.max_wait:
                            batch = q[: self.batch_size]
                            self._pending[b] = q[self.batch_size:]
                            bucket = b
                            break
                        expires = self.max_wait - age
                        deadline = min(deadline or expires, expires)
                    if batch is not None:
                        break
                    if self._stop:
                        return
                    self._cv.wait(timeout=deadline)
            try:
                self._flush(bucket, batch)
            except BaseException as e:  # resolve waiters, keep serving
                for req, _, _, _ in batch:
                    req.error = e
                    req.event.set()

    def _flush(self, bucket: int, batch):
        f, m = pack_chunk_batch(
            ((length, chunk) for _, length, chunk, _ in batch),
            bucket, self.config.feat_dim, self._wire_dtype)
        emb = to_numpy(self._embed(f, m))
        self.num_flushes += 1
        for i, (req, length, _, _) in enumerate(batch):
            # length-weighted chunk average; all chunks of a request resolve
            # on this thread, so no lock is needed
            req.acc = req.acc + emb[i] * length
            req.weight += length
            req.remaining -= 1
            if req.remaining == 0:
                req.event.set()

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        for q in self._pending.values():
            for req, _, _, _ in q:
                req.error = RuntimeError("service closed")
                req.event.set()
            q.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
