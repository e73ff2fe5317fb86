"""Embedding extraction: batched, bucketed, masked.

Chunking follows the reference rule:

    num_chunks = 1 + (T - 25) // 1000
    chunk i    = frames [i*1000, i*1000 + len_i), len_i = 1000 or the tail
    embedding  = sum_i emb_i * len_i / sum_i len_i

(a tail shorter than 25 frames is dropped; an utterance shorter than 25
frames gives one full-length chunk). Every chunk is zero-padded to one of a
few bucket lengths and batched; the model's masked pooling and per-block time
masking make the padded forward equal to the exact-length forward.

``embed_fn(feats (B, T, F), mask (B, T))`` returns a (B, D) float32 torch
tensor, possibly still being computed on the device; the host reads it one
batch later, so the device works on batch k while the host packs k+1.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_FRAMES = 1000
MIN_FRAMES = 25


def resolve_wire_dtype(wire: str) -> Optional[torch.dtype]:
    """Map a --wire flag value to the dtype of the host->device feature
    buffers (pack_chunk_batch). Raises on unknown values."""
    if wire == "float32":
        return None
    if wire == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"wire must be float32|bfloat16, got {wire!r}")


def default_batch_size(model_name: str) -> int:
    """Bucket batch per model class: 128 for the w24/att Res2Nets, 64
    otherwise. Inherited defaults of the JAX package, not yet measured on
    the GPU."""
    return 128 if ("w24" in model_name or "_att" in model_name) else 64


def chunk_spans(t: int, max_frames: int = MAX_FRAMES, min_frames: int = MIN_FRAMES):
    """[(start, length), ...] per the reference chunking rule."""
    if t < min_frames:
        return [(0, t)]
    num_chunks = 1 + (t - min_frames) // max_frames
    spans = []
    for i in range(num_chunks):
        start = i * max_frames
        length = max_frames if (i + 1) * max_frames <= t else t - start
        spans.append((start, length))
    return spans


def select_bucket(buckets: Sequence[int], length: int,
                  max_frames: int = MAX_FRAMES) -> int:
    """Smallest bucket holding a chunk of `length` frames (buckets sorted)."""
    return buckets[bisect.bisect_left(buckets, min(length, max_frames))]


def pack_chunk_batch(chunks, bucket: int, feat_dim: int,
                     wire_dtype: Optional[torch.dtype] = None):
    """Zero-pad chunk rows into one (B, bucket, F) feats + (B, bucket) mask
    pair of CPU tensors. ``chunks`` iterates (length, (length, F) feats).

    ``wire_dtype=torch.bfloat16`` packs the features in bf16 (round to
    nearest even), halving the host->device copy; the embed fn upcasts to
    float32 on the device, so for a bf16-compute model this equals the fp32
    wire."""
    chunks = list(chunks)
    f = np.zeros((len(chunks), bucket, feat_dim), np.float32)
    m = np.zeros((len(chunks), bucket), np.float32)
    for i, (length, feats) in enumerate(chunks):
        f[i, :length] = feats
        m[i, :length] = 1.0
    f = torch.from_numpy(f)
    return (f if wire_dtype is None else f.to(wire_dtype)), torch.from_numpy(m)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host float32 copy of a tensor (waits for the device)."""
    return t.detach().float().cpu().numpy()


def extract_embeddings(
    embed_fn: Callable,
    features: Iterable[Tuple[str, np.ndarray]],
    batch_size: int = 32,
    buckets: Sequence[int] = (256, 512, 1000),
    max_frames: int = MAX_FRAMES,
    min_frames: int = MIN_FRAMES,
    wire_dtype: Optional[torch.dtype] = None,
) -> Dict[str, np.ndarray]:
    """Extract one embedding per utterance.

    embed_fn(feats (B, T, F), mask (B, T)) -> (B, D).
    features: iterable of (utt, (T, F) CMVN'd features).
    """
    buckets = sorted(set(list(buckets) + [max_frames]))

    pending: Dict[int, List[Tuple[str, int, np.ndarray]]] = {b: [] for b in buckets}
    acc: Dict[str, Tuple[np.ndarray, float]] = {}
    inflight: List[Tuple[object, List[Tuple[str, int, np.ndarray]]]] = []

    def drain(keep: int = 0):
        while len(inflight) > keep:
            emb, batch = inflight.pop(0)
            emb = to_numpy(emb)
            for i, (utt, length, _) in enumerate(batch):
                s, w = acc.get(utt, (0.0, 0.0))
                acc[utt] = (s + emb[i] * length, w + length)

    def flush(bucket: int):
        batch = pending[bucket]
        if not batch:
            return
        f, m = pack_chunk_batch(
            ((length, feats) for _, length, feats in batch),
            bucket, batch[0][2].shape[1], wire_dtype)
        inflight.append((embed_fn(f, m), batch))
        pending[bucket] = []
        drain(1)

    for utt, feats in features:
        for start, length in chunk_spans(len(feats), max_frames, min_frames):
            bucket = select_bucket(buckets, length, max_frames)
            pending[bucket].append((utt, length, feats[start: start + length]))
            if len(pending[bucket]) >= batch_size:
                flush(bucket)
    for b in buckets:
        flush(b)
    drain()

    return {utt: (s / w).astype(np.float32) for utt, (s, w) in acc.items()}


def make_bucketed_embed_fn(embed_fn: Callable, batch_size: Optional[int] = None) -> Callable:
    """Wrap an embed fn so partial batches are padded to the full batch size:
    one batch shape per bucket, so every flush runs the same kernels at the
    same shapes. Pass the intended `batch_size` explicitly; otherwise the
    first call's batch pins the pad target."""

    cache = {"batch": batch_size} if batch_size else {}

    def wrapped(feats: torch.Tensor, mask: torch.Tensor):
        b = feats.shape[0]
        target = cache.setdefault("batch", b)
        if b < target:
            pad = target - b
            feats = torch.cat([feats, feats.new_zeros((pad,) + tuple(feats.shape[1:]))])
            # keep one valid frame in padded rows to avoid 0/0 in pooling
            mask_pad = mask.new_zeros((pad, mask.shape[1]))
            mask_pad[:, 0] = 1.0
            mask = torch.cat([mask, mask_pad])
            return embed_fn(feats, mask)[:b]
        return embed_fn(feats, mask)

    return wrapped
