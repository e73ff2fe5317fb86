"""Host-side feature normalization for extraction and serving."""

from __future__ import annotations

import numpy as np


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
