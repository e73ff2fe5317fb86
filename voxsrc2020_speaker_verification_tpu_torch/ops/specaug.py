"""SpecAugment, batched on the features' device.

The JAX package's ``ops/specaug.py`` semantics (the reference's sampling):
one time mask and one frequency mask per utterance, zero-filled, each drawn
in three steps

    f     ~ uniform{0 .. param-1}   (param: freq 5+1, time 8+1)
    start ~ uniform{0 .. max(dim-f, 1)-1}
    width ~ uniform{0 .. f-1}       (no mask at all when f == 0)

so the masked width is at most param - 2 (4 frequency bins, 7 frames).

The draws are explicit tensors (:func:`draw`) and the masks are built from
them (:func:`spec_augment`), so the tests can feed the JAX package's own
draws. The trainer draws from a generator seeded by (seed, step,
microbatch): the same distribution as JAX's threefry draws, not the same
numbers. Plain PyTorch: two broadcast comparisons and a multiply.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

FREQ_PARAM = 6  # ref tf_data.py:107 freq mask param 5+1
TIME_PARAM = 9  # ref tf_data.py:108 time mask param 8+1


class Draws(NamedTuple):
    """Per-utterance (B,) integer starts and widths of the two masks."""
    time_start: torch.Tensor
    time_width: torch.Tensor
    freq_start: torch.Tensor
    freq_width: torch.Tensor


def _draw_1d(u: torch.Tensor, dim: int, param: int):
    """(start, width) from three uniform [0, 1) columns of ``u`` (B, 3), by
    the three-step rule."""
    f = torch.floor(u[:, 0] * param).long().clamp(max=param - 1)
    high = torch.clamp(dim - f, min=1)
    start = torch.minimum(torch.floor(u[:, 1] * high).long(), high - 1)
    fw = torch.clamp(f, min=1)
    width = torch.where(f > 0, torch.minimum(torch.floor(u[:, 2] * fw).long(), fw - 1),
                        torch.zeros_like(f))
    return start, width


def draw(batch: int, tlen: int, flen: int, generator: Optional[torch.Generator] = None,
         device=None, freq_param: int = FREQ_PARAM, time_param: int = TIME_PARAM) -> Draws:
    """One time and one frequency mask per utterance of a (batch, tlen, flen)
    batch, drawn from ``generator`` (on ``device``)."""
    u = torch.rand((batch, 2, 3), generator=generator, device=device, dtype=torch.float64)
    ts, tw = _draw_1d(u[:, 0], tlen, time_param)
    fs, fw = _draw_1d(u[:, 1], flen, freq_param)
    return Draws(ts, tw, fs, fw)


def _keep(start: torch.Tensor, width: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    idx = torch.arange(dim, device=start.device)[None, :]
    hit = (idx >= start[:, None]) & (idx < (start + width)[:, None])
    return torch.where(hit, 0.0, 1.0).to(dtype)


def spec_augment(feats: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Zero each utterance's time and frequency band: feats (B, T, F) times
    the time keep-mask, times the frequency keep-mask (in that order, in
    feats' dtype, as the JAX package multiplies)."""
    _, t, f = feats.shape
    tmask = _keep(draws.time_start, draws.time_width, t, feats.dtype)
    fmask = _keep(draws.freq_start, draws.freq_width, f, feats.dtype)
    return feats * tmask[:, :, None] * fmask[:, None, :]
