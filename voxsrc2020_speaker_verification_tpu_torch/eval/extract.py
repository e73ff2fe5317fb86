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

Over several devices (:func:`extraction_devices`, :func:`sharded_embed_fn`)
one process drives a replica of the model on each: every bucket batch is
split into contiguous row blocks, one a device, as the JAX package's mesh
shards the batch axis.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

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
    pair. ``chunks`` iterates (length, (length, F) feats): numpy rows pack
    into CPU tensors, tensor rows (features already on the device) pack
    where they lie.

    ``wire_dtype=torch.bfloat16`` packs the features in bf16 (round to
    nearest even), halving the host->device copy of numpy rows; the embed
    fn upcasts to float32 on the device, so for a bf16-compute model this
    equals the fp32 wire."""
    chunks = list(chunks)
    m = np.zeros((len(chunks), bucket), np.float32)
    for i, (length, _) in enumerate(chunks):
        m[i, :length] = 1.0
    if chunks and isinstance(chunks[0][1], torch.Tensor):
        f = torch.zeros((len(chunks), bucket, feat_dim), device=chunks[0][1].device)
        for i, (length, feats) in enumerate(chunks):
            f[i, :length] = feats
        m = torch.from_numpy(m).to(f.device)
    else:
        f = np.zeros((len(chunks), bucket, feat_dim), np.float32)
        for i, (length, feats) in enumerate(chunks):
            f[i, :length] = feats
        f, m = torch.from_numpy(f), torch.from_numpy(m)
    return (f if wire_dtype is None else f.to(wire_dtype)), m


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
    features: iterable of (utt, (T, F) CMVN'd features), numpy arrays or
    tensors on the embed fn's device.
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


def extraction_devices(num_devices: int = 0,
                       device: Optional[Union[str, torch.device]] = None) -> List[torch.device]:
    """The devices an extraction runs on, the JAX CLI's ``--num-devices``
    rule: 0 means every local card (``torch.cuda.device_count()``), or one
    on the CPU; N > 0 means N, ``cuda:0`` .. ``cuda:N-1`` on the card and N
    CPU replicas on ``device="cpu"``. Asking for more cards than are present
    raises: nothing falls back to fewer."""
    from .. import resolve_device

    dev = resolve_device(device)
    if num_devices < 0:
        raise ValueError(f"num_devices must be >= 0, got {num_devices}")
    if dev.type != "cuda":
        return [dev] * max(1, num_devices)
    present = torch.cuda.device_count()
    n = num_devices or present
    if n > present:
        raise ValueError(f"--num-devices {n} asks for more cards than present ({present})")
    if n == 1:
        return [dev]
    if dev.index not in (None, 0):
        raise ValueError(f"--num-devices {n} takes cuda:0 .. cuda:{n - 1}; got --device {dev}")
    return [torch.device("cuda", i) for i in range(n)]


def round_up_batch(batch_size: int, num_devices: int) -> int:
    """The bucket batch rounded up to a multiple of the device count."""
    return -(-batch_size // num_devices) * num_devices


def sharded_embed_fn(embed_fns: Sequence[Callable]) -> Callable:
    """One embed fn over N replicas, ``embed_fns[i]`` on its own device: a
    batch of B rows (B a multiple of N) is split into N contiguous row
    blocks, block i goes to replica i (which copies it to its device), all N
    are launched before any result is read, and the rows come back in order
    on the first replica's device (device-to-device copies, which do not
    wait on the host)."""
    fns = list(embed_fns)
    if len(fns) == 1:
        return fns[0]

    def embed(feats, mask):
        b = feats.shape[0]
        if b % len(fns):
            raise ValueError(f"a batch of {b} rows does not split over {len(fns)} devices")
        k = b // len(fns)
        outs = [fn(feats[i * k:(i + 1) * k], mask[i * k:(i + 1) * k])
                for i, fn in enumerate(fns)]
        return torch.cat([o.to(outs[0].device, non_blocking=True) for o in outs])

    return embed
