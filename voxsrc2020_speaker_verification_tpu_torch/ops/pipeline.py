"""Device-side training front end of raw-audio training: waveform crops ->
training features, the JAX package's ``ops/pipeline.py``.

Waveform crops (int16 on the wire) go to the card, and inside the train
step: a cast to float32, FBANK (K1, dithered when draws are given), the
Kaldi frame count of each crop, centred sliding CMN over the crop's valid
frames (K7), and the crop gather with its zero tail.

CMN parity: the reference applies the 300-frame centred window to the
whole utterance and then crops 200 feature frames. The host loader
(``data/raw_dataset.py``, ``data/native.py:NativeRawBatchFeeder``) sends
each crop with up to ``context`` frames on either side, clipped at the
utterance's ends; with the Kaldi rule start = clip(t - 150, 0, n - 300), a
crop that carries full context or abuts an end gives every target frame
the window of the whole utterance.

Short utterances (fewer than ``feat_length`` frames) come whole, with a
random ``pad_shift``: their valid rows land at that shift inside zero rows,
as the reference zero-pads its feature matrix.

The gather is plain torch indexing (~20 MB a microbatch at 256 x 200 x 80);
:func:`waveform_to_features_reference` is the same pipeline through the
plain versions of K1 and K7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .cmvn import sliding_cmvn, sliding_cmvn_reference
from .fbank import FbankConfig, fbank, fbank_reference


def crop_samples(feat_length: int, cfg: FbankConfig) -> int:
    """Waveform samples needed for exactly ``feat_length`` frames."""
    return (feat_length - 1) * cfg.frame_shift + cfg.frame_length


def max_crop_samples(feat_length: int, context: int, cfg: FbankConfig) -> int:
    """Host buffer size: the crop plus CMN context on both sides."""
    return crop_samples(feat_length + 2 * context, cfg)


def num_frames_batch(num_samples: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """Kaldi snip-edges frame count of each entry (0 below one window)."""
    t = 1 + torch.div(num_samples.long() - cfg.frame_length, cfg.frame_shift,
                      rounding_mode="floor")
    return torch.clamp(t, min=0)


def crop_gather(feats: torch.Tensor, valid: torch.Tensor, target_offset: torch.Tensor,
                pad_shift: torch.Tensor, feat_length: int) -> torch.Tensor:
    """(B, T, F) -> (B, feat_length, F): rows ``target_offset`` on placed at
    ``pad_shift``, zeros outside the crop's valid frames."""
    t = feats.shape[1]
    rows = torch.arange(feat_length, device=feats.device)[None, :]
    off, shift = target_offset.long()[:, None], pad_shift.long()[:, None]
    src = rows - shift + off
    in_range = (rows >= shift) & (src < torch.minimum(valid.long()[:, None], off + feat_length))
    index = src.clamp(0, t - 1)[:, :, None].expand(-1, -1, feats.shape[2])
    gathered = torch.gather(feats, 1, index)
    return torch.where(in_range[:, :, None], gathered, gathered.new_zeros(()))


def _front_end(fbank_fn, cmvn_fn, waves, num_samples, target_offset, pad_shift, cfg,
               feat_length, window, noise):
    if noise is None:
        cfg = dataclasses.replace(cfg, dither=0.0)
    feats = fbank_fn(waves.float(), cfg, noise)
    valid = num_frames_batch(num_samples, cfg)
    feats = cmvn_fn(feats, valid, window=window, center=True)
    return crop_gather(feats, valid, target_offset, pad_shift, feat_length)


def waveform_to_features(waves: torch.Tensor, num_samples: torch.Tensor,
                         target_offset: torch.Tensor, pad_shift: torch.Tensor,
                         cfg: FbankConfig, feat_length: int, *, window: int = 300,
                         context: int = 150,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Smax) waveform crops (int16 or float32, int16 scale, zero-padded)
    -> (B, feat_length, F) float32 training features.

    ``num_samples`` (B,) valid samples of each crop; ``target_offset`` (B,)
    the first target frame within the crop; ``pad_shift`` (B,) the zero-pad
    shift of a short utterance (0 otherwise). ``noise`` (B, T, frame_length)
    float32 turns on dither (``cfg.dither`` its scale); without it dither is
    off whatever ``cfg.dither`` says, as the JAX package's ``dither_key=None``.
    ``context`` documents the loader's contract and is not needed here.

    On CUDA tensors K1 and K7 run; on CPU tensors their plain versions.
    """
    del context
    return _front_end(fbank, sliding_cmvn, waves, num_samples, target_offset, pad_shift,
                      cfg, feat_length, window, noise)


def waveform_to_features_reference(waves, num_samples, target_offset, pad_shift,
                                   cfg: FbankConfig, feat_length: int, *, window: int = 300,
                                   context: int = 150, noise=None) -> torch.Tensor:
    """:func:`waveform_to_features` through the plain versions of K1 and K7
    (on any device): the yardstick of the pipeline on the card."""
    del context
    return _front_end(fbank_reference, sliding_cmvn_reference, waves, num_samples,
                      target_offset, pad_shift, cfg, feat_length, window, noise)
