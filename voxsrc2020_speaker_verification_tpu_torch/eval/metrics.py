"""EER and minDCF.

The ROC is computed as ``sklearn.metrics.roc_curve`` computes it (distinct
thresholds in descending order, ``drop_intermediate`` on, a leading
``inf`` threshold), in numpy, so the port needs no scikit-learn:

* EER = FPR at argmin |FNR - FPR|
* minDCF: linear scan of c_miss*FNR*p + c_fa*FPR*(1-p) over the ROC
  thresholds, normalized by min(c_miss*p, c_fa*(1-p)); defaults
  p_target=0.01, c_miss=c_fa=1.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def roc_curve(labels: Sequence[int], scores: Sequence[float]):
    """(fpr, tpr, thresholds) with label 1 positive."""
    y = np.asarray(labels) == 1
    s = np.asarray(scores, np.float64)
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    idx = np.r_[np.where(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    thresholds = s[idx]
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    return fps / fps[-1], tps / tps[-1], thresholds


def compute_eer_and_min_dcf(
    labels: Sequence[int],
    scores: Sequence[float],
    c_miss: float = 1.0,
    c_fa: float = 1.0,
    p_target: float = 0.01,
) -> Tuple[float, float, float, float]:
    """Returns (eer, eer_threshold, min_dcf, min_dcf_threshold)."""
    fprs, tprs, thresholds = roc_curve(labels, scores)
    fnrs = 1.0 - tprs

    idx = int(np.nanargmin(np.abs(fnrs - fprs)))
    eer = float(fprs[idx])
    eer_threshold = float(thresholds[idx])

    c_det = c_miss * fnrs * p_target + c_fa * fprs * (1.0 - p_target)
    j = int(np.argmin(c_det))
    c_def = min(c_miss * p_target, c_fa * (1.0 - p_target))
    return eer, eer_threshold, float(c_det[j] / c_def), float(thresholds[j])


def evaluate_trials(trials, scores, p_target: float = 0.01):
    """(eer%, minDCF) from (label, utt1, utt2) trials + scores."""
    labels = [t[0] for t in trials]
    eer, _, min_dcf, _ = compute_eer_and_min_dcf(labels, scores, p_target=p_target)
    return eer * 100.0, min_dcf
