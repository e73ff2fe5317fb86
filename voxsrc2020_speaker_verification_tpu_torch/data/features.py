"""FBANK feature extraction for a data dir: wav.scp in, Kaldi ark/scp out.

The JAX package's ``data/features.py``: the reference's ``compute-fbank-feats
| copy-feats --compress`` stage (prepare_data.sh:66-71, 161-166) on the card.

* waveforms (plain wavs or JSON augmentation specs, rendered by the native
  library or ``data/augment.py``) are loaded by a host thread pool,
* bucketed by length and batched, int16 on the host-to-device wire,
* log-mel FBANK computed by K1 (``ops/fbank.py:fbank``) on the device,
* written as Kaldi ark/scp (CM-compressed like ``copy-feats --compress``, or
  plain) by ``data/kaldi_io.py``, so either package reads the result.

``cli/extract.py --raw`` takes the same batches (:func:`wave_feature_batches`)
and keeps them on the device.

Dither (``dither_seed``) runs K1's dithered variant: Kaldi's dither 1.0
with draws from a ``torch.Generator`` seeded by ``dither_seed``, one
(B, T, frame_length) draw a batch. The JAX package draws from threefry keys
split from the same seed: the distribution is the same, the numbers are
not.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops.fbank import FbankConfig, draw_noise, fbank, num_frames, pcm16
from ..utils import datadir
from . import kaldi_io
from .augment import load_utterance

DEFAULT_BUCKETS_S = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def _bucket_for(n_samples: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n_samples <= b:
            return b
    return buckets[-1]


def fbank_int16(waves: np.ndarray, cfg: FbankConfig, device: torch.device,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, S) int16 samples -> (B, T, num_bins) float32 on ``device``: the
    int16 wire (half the bytes of float32), widened on the device, then K1
    (the plain version on the CPU); dithered with draws from ``generator``
    where one is given."""
    w = torch.from_numpy(np.ascontiguousarray(waves, np.int16)).to(device).float()
    noise = None if generator is None else draw_noise(*w.shape, cfg, generator, device)
    return fbank(w, cfg, noise)


def utterance_loader():
    """(load, name): the native C++ renderer of wav.scp values
    (``data/native.py:render_spec``, 16-bit PCM) where the native library
    builds, else the Python one (``data/augment.py:load_utterance``)."""
    from . import native

    if native.available():
        return native.render_spec, "native"
    return load_utterance, "python"


def wave_feature_batches(
    wav_scp: str,
    feat_dim: int = 80,
    *,
    batch_size: int = 16,
    bucket_seconds: Sequence[int] = DEFAULT_BUCKETS_S,
    sample_rate: int = 16000,
    io_threads: int = 8,
    device: Optional[Union[str, torch.device]] = None,
    dither_seed: Optional[int] = None,
) -> Iterator[Tuple[torch.Tensor, List[Tuple[str, int]]]]:
    """FBANK straight from a wav.scp: yields (features (B, frames, F) on
    ``device`` (default ``cuda``), [(utt, valid frames), ...]) batch by
    batch, K1 over an int16 wire in audio-length buckets. A host thread pool
    renders the wav.scp values with :func:`utterance_loader` (it prints
    which). Utterances longer than the largest bucket are truncated to it
    (128 s covers every VoxCeleb utterance). ``dither_seed`` turns on
    dither 1.0, its draws from a generator of that seed."""
    dev = resolve_device(device)
    cfg = FbankConfig(num_bins=feat_dim, dither=0.0 if dither_seed is None else 1.0)
    gen = (None if dither_seed is None
           else torch.Generator(device=dev).manual_seed(dither_seed))
    load, renderer = utterance_loader()
    print(f"renderer: {renderer}", flush=True)
    wav = datadir.read_two_column(wav_scp)
    keys = sorted(wav)
    buckets = [s * sample_rate for s in bucket_seconds]
    pending: Dict[int, List[Tuple[str, int, np.ndarray]]] = {b: [] for b in buckets}

    def flush(bucket: int):
        batch, pending[bucket] = pending[bucket], []
        waves = np.zeros((len(batch), bucket), np.int16)
        for i, (_, n, w) in enumerate(batch):
            waves[i, :n] = pcm16(w[:n])
        return (fbank_int16(waves, cfg, dev, gen),
                [(utt, num_frames(n, cfg)) for utt, n, _ in batch])

    with cf.ThreadPoolExecutor(max_workers=io_threads) as pool:
        for utt, (samples, sr) in zip(keys, pool.map(lambda u: load(wav[u]), keys)):
            if sr != sample_rate:
                raise ValueError(f"{utt}: sample rate {sr}, expected {sample_rate}")
            n = min(len(samples), buckets[-1])
            b = _bucket_for(n, buckets)
            pending[b].append((utt, n, samples))
            if len(pending[b]) >= batch_size:
                yield flush(b)
        for b in buckets:
            if pending[b]:
                yield flush(b)


def compute_features_for_dir(
    data_dir: str,
    feat_dim: int = 80,
    *,
    out_name: Optional[str] = None,
    compress: bool = True,
    batch_size: int = 16,
    bucket_seconds: Sequence[int] = DEFAULT_BUCKETS_S,
    sample_rate: int = 16000,
    dither_seed: Optional[int] = None,
    io_threads: int = 8,
    progress_every: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Compute ``<out_name>.ark/.scp`` (default ``fbank<feat_dim>``) and
    ``utt2num_frames`` for a data dir on ``device`` (default ``cuda``)
    through :func:`wave_feature_batches` (dithered with ``dither_seed``).
    Returns the scp path."""
    out_name = out_name or f"fbank{feat_dim}"
    ark = os.path.join(data_dir, out_name + ".ark")
    scp = os.path.join(data_dir, out_name + ".scp")
    utt2num: Dict[str, str] = {}
    batches = wave_feature_batches(
        os.path.join(data_dir, "wav.scp"), feat_dim, batch_size=batch_size,
        bucket_seconds=bucket_seconds, sample_rate=sample_rate, io_threads=io_threads,
        device=device, dither_seed=dither_seed)
    with kaldi_io.ArkScpWriter(ark, scp, compress=compress) as writer:
        for feats, rows in batches:
            feats = feats.cpu().numpy()
            for i, (utt, t) in enumerate(rows):
                writer.write(utt, feats[i, :t])
                utt2num[utt] = str(t)
                if progress_every and len(utt2num) % progress_every == 0:
                    print(f"  fbank: {len(utt2num)} utts")
    datadir.write_two_column(os.path.join(data_dir, "utt2num_frames"), utt2num)
    return scp


def finalize_dataset(data_dir: str, feat_dim: int, num_shards: Sequence[int] = (8, 16, 32),
                     shuffle_seed: int = 777) -> None:
    """Post-feature bookkeeping (ref prepare_data.sh:73-87): shuffled scp,
    spk list, utt2id.pkl, {N}-split shards."""
    scp = os.path.join(data_dir, f"fbank{feat_dim}.scp")
    datadir.shuffle_scp(scp, seed=shuffle_seed)
    utt2spk = datadir.read_two_column(os.path.join(data_dir, "utt2spk"))
    spks = sorted(set(utt2spk.values()))
    with open(os.path.join(data_dir, "spk"), "w") as f:
        f.write("\n".join(spks) + "\n")
    utt2id = datadir.build_utt2id(utt2spk, spks)
    datadir.save_utt2id(os.path.join(data_dir, "utt2id.pkl"), utt2id)
    for n in num_shards:
        datadir.shard_scp(scp, n)
