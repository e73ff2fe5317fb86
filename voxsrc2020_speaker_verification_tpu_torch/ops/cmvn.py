"""Sliding-window cepstral mean (and variance) normalization over time, a
plain PyTorch version and the CUDA kernel K7 (``csrc/sliding_cmvn.cu``).

The JAX package's ``ops/cmvn.py``: Kaldi ``apply-cmvn-sliding`` with
``--center=true --norm-vars=false --cmn-window=300`` by default. For frame t
of an utterance with n valid frames the window is

    centred:  start = clip(t - w//2, 0, max(0, n - w)),  end = min(start + w, n)
    trailing: end = min(max(t + 1, min(min_window, n)), n),
              start = min(max(t - w + 1, 0), max(end - w, 0))

and the window mean is subtracted (with ``norm_vars``, the result is also
divided by the window's standard deviation, its variance floored at 1e-10).
Padded frames (t >= n) never enter a window; they are normalized with the
last window's statistics, to be masked downstream.

Both versions sum in float64: the plain one over a whole-utterance
cumulative sum (as ``data/dataset.py:sliding_cmn_np`` does for one
utterance, batched), the kernel over a window it slides along each tile of
frames. The JAX version's float32 cumulative sum drifts with T (~1.5e-4 at
16000 frames on features of 12 +- 3), so both are held against float64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import SLIDING_CMVN, check_cuda, ptr


def window_bounds(t: int, n: torch.Tensor, window: int, center: bool,
                  min_window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end), each (B, T) int64, of every frame's window for valid
    frame counts ``n`` (B,)."""
    ts = torch.arange(t, device=n.device)[None, :]
    n = n.long()[:, None]
    if center:
        start = torch.minimum(torch.clamp(ts - window // 2, min=0),
                              torch.clamp(n - window, min=0))
        end = torch.minimum(start + window, n)
    else:
        end = torch.minimum(torch.maximum(ts + 1, torch.clamp(n, max=min_window)), n)
        start = torch.minimum(torch.clamp(ts - window + 1, min=0),
                              torch.clamp(end - window, min=0))
    return start, end


def _valid_counts(num_valid, b: int, t: int, device) -> Optional[torch.Tensor]:
    if num_valid is None:
        return None
    n = torch.as_tensor(num_valid, device=device).reshape(-1)
    if n.shape != (b,):
        raise ValueError(f"num_valid has {tuple(n.shape)} entries for a batch of {b}")
    return n


def sliding_cmvn_reference(feats: torch.Tensor, num_valid=None, *, window: int = 300,
                           center: bool = True, norm_vars: bool = False,
                           min_window: int = 100) -> torch.Tensor:
    """Plain version: (B, T, F) -> (B, T, F) in ``feats``' dtype, through a
    float64 cumulative sum over time. ``num_valid`` (B,) counts are clamped
    to [0, T]; None means every frame is valid."""
    b, t, f = feats.shape
    n = _valid_counts(num_valid, b, t, feats.device)
    n = (torch.full((b,), t, device=feats.device) if n is None else n.long().clamp(0, t))
    x = feats.double()
    valid = (torch.arange(t, device=feats.device)[None, :] < n[:, None]).double()
    xz = x * valid[:, :, None]
    start, end = window_bounds(t, n, window, center, min_window)
    count = torch.clamp(end - start, min=1).double()[:, :, None]

    def window_sum(v):
        c = torch.cat([v.new_zeros((b, 1, f)), torch.cumsum(v, dim=1)], dim=1)
        at = lambda idx: torch.gather(c, 1, idx[:, :, None].expand(b, t, f))
        return at(end) - at(start)

    mean = window_sum(xz) / count
    out = x - mean
    if norm_vars:
        var = window_sum(xz * xz) / count - mean * mean
        out = out * torch.rsqrt(torch.clamp(var, min=1e-10))
    return out.to(feats.dtype)


def sliding_cmvn(feats: torch.Tensor, num_valid=None, *, window: int = 300,
                 center: bool = True, norm_vars: bool = False,
                 min_window: int = 100) -> torch.Tensor:
    """Sliding CMN (CMVN with ``norm_vars``) over the time axis of (B, T, F)
    or (T, F) features padded beyond ``num_valid`` (B,) frames (None: all
    valid). On a CUDA tensor (float32) this launches K7 with every flag; on
    a CPU tensor it runs :func:`sliding_cmvn_reference`."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    kw = dict(window=window, center=center, norm_vars=norm_vars, min_window=min_window)
    if feats.ndim == 2:
        n = None if num_valid is None else torch.as_tensor(num_valid).reshape(1)
        return sliding_cmvn(feats[None], n, **kw)[0]
    if feats.ndim != 3:
        raise ValueError(f"sliding_cmvn takes (B, T, F) or (T, F), got {tuple(feats.shape)}")
    if feats.device.type == "cpu":
        return sliding_cmvn_reference(feats, num_valid, **kw)

    check_cuda("sliding_cmvn", feats, (torch.float32,), 3)
    b, t, f = feats.shape
    n = _valid_counts(num_valid, b, t, feats.device)
    if n is not None:
        n = n.to(torch.int32).contiguous()
    out = torch.empty_like(feats)
    if out.numel() == 0:
        return out
    SLIDING_CMVN.launch("sliding_cmvn", feats.device, ptr(feats), ptr(n), ptr(out), b, t, f,
                        window, int(center), int(norm_vars), min_window)
    return out


def global_cmvn(feats: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Global mean/std normalization (the reference's cmvn_pkl path)."""
    return (feats - mean) / std
