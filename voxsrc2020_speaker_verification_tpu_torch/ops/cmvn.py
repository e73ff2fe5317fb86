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
utterance, batched), the kernel over prefixes of the rows that one tile's
windows cover, staged once in shared memory (:func:`sliding_cmvn_plan`).
The JAX version's float32 cumulative sum drifts with T (~1.5e-4 at 16000
frames on features of 12 +- 3), so both are held against float64.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..kernels import SLIDING_CMVN, check_cuda, num_sms, ptr

# K7's launch plan: 256 threads a CTA, the most shared memory one block
# takes on the H100, and the rows a thread sums or the frames it walks
# (odd: conflict-free shared-memory reads, csrc/sliding_cmvn.cu)
K7_THREADS, K7_SMEM_MAX, K7_SEG = 256, 232448, 17


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


def window_at(t: int, n: int, window: int, center: bool, min_window: int) -> Tuple[int, int]:
    """(start, end) of frame t's window for n valid frames: one frame of
    :func:`window_bounds`, as the kernel computes it."""
    if center:
        start = min(max(t - window // 2, 0), max(0, n - window))
        return start, min(start + window, n)
    end = min(max(t + 1, min(min_window, n)), n)
    return min(max(t - window + 1, 0), max(end - window, 0)), end


def tile_extent(t0: int, t1: int, n: int, window: int, center: bool,
                min_window: int) -> Tuple[int, int]:
    """The rows [r0, r1) that K7 stages for frames [t0, t1) of an utterance
    with n valid frames: both window edges are monotone in t, so the
    windows of the tile lie inside [start(t0), end(t1 - 1))."""
    return (window_at(t0, n, window, center, min_window)[0],
            window_at(t1 - 1, n, window, center, min_window)[1])


def extent_rows(t: int, tt: int, window: int, center: bool, min_window: int) -> int:
    """The most rows :func:`tile_extent` gives a tile of tt frames at any n
    <= t: each edge moves by at most one row a frame, and one window holds at
    most ``reach`` rows (w, or the trailing rule's min_window where larger)."""
    reach = window if center else max(window, min(min_window, t))
    return min(t, tt - 1 + reach)


def _k7_smem(rows: int, fb: int, seg: int, staged: bool, norm_vars: bool) -> int:
    """csrc/sliding_cmvn.cu:smem_bytes: the staged rows, and a float64 prefix
    a segment base (and the extent's end) a bin, twice with norm_vars."""
    prefixes = (-(-rows // seg) + 1) * fb * 8 * (2 if norm_vars else 1)
    return (rows * fb * 4 if staged else 0) + prefixes


@functools.lru_cache(maxsize=256)
def sliding_cmvn_plan(b: int, t: int, f: int, window: int, center: bool = True,
                      norm_vars: bool = False, min_window: int = 100,
                      sms: int = 132) -> dict:
    """K7's launch plan for a (b, t, f) batch: one CTA a (utterance, tile of
    ``tt`` frames, group of ``fb`` bins). Tiles of 512 frames and groups of
    8 bins where the batch gives at least two such CTAs an SM of ``sms``
    (long utterances: many small CTAs, three resident an SM, one's
    arithmetic over another's staging); otherwise 256 frames (at most t) and
    16 bins (short batches: fewer CTAs, each staging less of its
    neighbours' rows). Of tt in {128 ... 1024} x fb in {8, 16}, this choice
    is the fastest or within 4% of it at every extraction bucket on the
    H100 (``scripts/time_k7.py --plans``, PERF.md §6).
    ``staged``: the tile's extent (``rows``) fits one block's shared memory
    with the prefixes; where it does not (a window of thousands of frames),
    the kernel reads the rows from global memory and ``seg`` grows (odd)
    until the prefixes fit. ``smem`` is what the C entry recomputes and
    checks."""
    def groups_of(fb):
        return -(-f // fb)

    fb, tt = 8, 512
    if b * -(-t // tt) * groups_of(fb) < 2 * sms:
        fb, tt = 16, 256
    fb = min(fb, -(-f // 4) * 4)
    tt = max(1, min(tt, t))
    rows = extent_rows(t, tt, window, center, min_window)
    seg, staged = K7_SEG, True
    smem = _k7_smem(rows, fb, seg, staged, norm_vars)
    if smem > K7_SMEM_MAX:
        staged = False
        entries = K7_SMEM_MAX // (fb * 8 * (2 if norm_vars else 1))
        seg = max(K7_SEG, -(-rows // (entries - 1)) | 1)
        smem = _k7_smem(rows, fb, seg, staged, norm_vars)
    tiles = -(-t // tt)
    return dict(tt=tt, fb=fb, seg=seg, staged=staged, rows=rows, tiles=tiles,
                groups=groups_of(fb), grid=b * tiles * groups_of(fb), threads=K7_THREADS,
                smem=smem)


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
    valid). On a CUDA tensor (float32) this launches K7 with every flag, on
    the plan of :func:`sliding_cmvn_plan`; on a CPU tensor it runs
    :func:`sliding_cmvn_reference`."""
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
    plan = sliding_cmvn_plan(b, t, f, window, bool(center), bool(norm_vars), min_window,
                             num_sms(feats.device))
    SLIDING_CMVN.launch("sliding_cmvn", feats.device, ptr(feats), ptr(n), ptr(out), b, t, f,
                        window, int(center), int(norm_vars), min_window, plan["tt"],
                        plan["fb"], plan["seg"], int(plan["staged"]), plan["smem"])
    return out


def global_cmvn(feats: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Global mean/std normalization (the reference's cmvn_pkl path)."""
    return (feats - mean) / std
