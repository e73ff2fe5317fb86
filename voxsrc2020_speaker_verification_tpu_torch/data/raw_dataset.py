"""Raw-audio training samples from a wav.scp, the JAX package's
``data/raw_dataset.py``.

Each sample is a waveform crop with CMN context (``ops/pipeline.py``) from
a wav.scp entry: a wav path or a JSON augmentation spec, rendered on the
fly by ``data/augment.py:load_utterance``. The crop position follows the
reference's feature-domain random crop: t0 ~ U[0, n - feat_length] for a
long utterance, a random zero-pad shift for a short one. The RNG calls
(``np.random.RandomState(seed)``: the skip draw, then the crop draw) are the
JAX package's, in its order, so a seed gives the same crops bit for bit.
``data/native.py:NativeRawBatchFeeder`` does the same work in C++.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from ..ops.fbank import FbankConfig, num_frames
from ..ops.pipeline import max_crop_samples
from ..utils import datadir
from .augment import load_utterance


class RawAudioShardDataset:
    """Endless ((wave, num_samples, target_offset, pad_shift), label) stream
    over one shard (every ``num_shards``-th entry from ``shard_index``) of a
    wav.scp. Training mode skips ~``skip_percent``% of the entries at random
    on every pass and crops at random; eval mode makes one pass, crops at
    random and pads short utterances at shift 0."""

    def __init__(self, wav_scp: str, utt2id: Dict[str, int], feat_length: int, *,
                 cfg: FbankConfig = FbankConfig(), context: int = 150,
                 shard_index: int = 0, num_shards: int = 1, training: bool = True,
                 skip_percent: int = 10, seed: int = 0):
        self.entries = list(datadir.read_two_column(wav_scp).items())[shard_index::num_shards]
        if not self.entries:
            raise ValueError(f"shard {shard_index} of {num_shards} of {wav_scp} is empty")
        self.utt2id = utt2id
        self.feat_length = feat_length
        self.cfg = cfg
        self.context = context
        self.training = training
        self.skip_percent = skip_percent
        self.rng = np.random.RandomState(seed)
        self.max_samples = max_crop_samples(feat_length, context, cfg)

    def crop(self, samples: np.ndarray) -> Tuple[np.ndarray, np.int32, np.int32, np.int32]:
        """-> (wave (max_samples,) int16, num_samples, target_offset,
        pad_shift). int16 on the wire: the samples are int16-scale (mixes
        clipped as the reference's wav round trip clips them), and the
        device pipeline casts to float32."""
        samples = np.clip(np.round(samples), -32768, 32767)
        cfg, length = self.cfg, self.feat_length
        n = num_frames(len(samples), cfg)
        out = np.zeros(self.max_samples, np.int16)
        if n >= length:
            t0 = self.rng.randint(n - length + 1)
            lo = max(0, t0 - self.context)
            hi = min(n, t0 + length + self.context)
            s_lo = lo * cfg.frame_shift
            s_hi = min(len(samples), (hi - 1) * cfg.frame_shift + cfg.frame_length)
            piece = samples[s_lo:s_hi]
            out[:len(piece)] = piece
            return out, np.int32(len(piece)), np.int32(t0 - lo), np.int32(0)
        shift = self.rng.randint(length - n + 1) if self.training else 0
        out[:len(samples)] = samples
        return out, np.int32(len(samples)), np.int32(0), np.int32(shift)

    def __iter__(self) -> Iterator[Tuple]:
        while True:
            for utt, rxwav in self.entries:
                if self.training and self.rng.randint(0, 100) >= 100 - self.skip_percent:
                    continue
                samples, _ = load_utterance(rxwav)
                if num_frames(len(samples), self.cfg) < 1:
                    continue
                label = np.int32(self.utt2id[utt]) if self.utt2id else utt
                yield self.crop(samples), label
            if not self.training:
                return
