"""Trial scoring: cosine similarity + adaptive symmetric s-norm.

* all test vectors l2-normalized on read
* speaker (cohort) embeddings: per-speaker mean of l2-normalized utterance
  vectors, not re-normalized after the mean
* cosine score = plain dot of the two (normalized) trial vectors
* adaptive s-norm: per-trial-side z-norm against the top-400 scores vs the
  cohort, symmetric 0.5*(z1+z2)

The cohort scoring is one float32 (block, D) x (D, cohort) matmul + top-k on
the device per trial block (``torch.matmul`` + ``torch.topk``), then tiny
per-trial arithmetic on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device


def l2norm(x: np.ndarray, axis: int = -1) -> np.ndarray:
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def speaker_means(
    xvectors: Dict[str, np.ndarray], spk2utt: Dict[str, List[str]]
) -> Dict[str, np.ndarray]:
    """Per-speaker mean of l2-normalized utterance vectors; the mean itself
    is deliberately not re-normalized (reference behavior)."""
    out = {}
    for spk, utts in spk2utt.items():
        vecs = [xvectors[u] for u in utts if u in xvectors]
        if vecs:
            out[spk] = l2norm(np.stack(vecs), axis=1).mean(axis=0)
    return out


def read_trials(path: str) -> List[Tuple[int, str, str]]:
    """Trial file lines: '<label> <utt1> <utt2>' (label optional for scoring)."""
    trials = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 3:
                trials.append((int(parts[0]), parts[1], parts[2]))
            elif len(parts) == 2:
                trials.append((-1, parts[0], parts[1]))
    return trials


def _trial_index(
    xvectors: Dict[str, np.ndarray], trials: Sequence[Tuple[int, str, str]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(matrix (U, D), i1 (N,), i2 (N,)) for the utterances trials touch."""
    utts = sorted({u for _, a, b in trials for u in (a, b)})
    idx = {u: i for i, u in enumerate(utts)}
    mat = np.stack([xvectors[u] for u in utts]).astype(np.float32)
    i1 = np.fromiter((idx[a] for _, a, _ in trials), np.int64, len(trials))
    i2 = np.fromiter((idx[b] for _, _, b in trials), np.int64, len(trials))
    return mat, i1, i2


def cosine_scores(
    xvectors: Dict[str, np.ndarray], trials: Sequence[Tuple[int, str, str]]
) -> np.ndarray:
    """Dot products of (pre-normalized) trial vectors."""
    return np.array(
        [float(np.dot(xvectors[u1], xvectors[u2])) for _, u1, u2 in trials],
        dtype=np.float64,
    )


def cohort_stats(
    trial_matrix: np.ndarray,
    cohort_matrix: np.ndarray,
    topk: int = 400,
    device: Optional[Union[str, torch.device]] = None,
    block_rows: int = 8192,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-trial-vector mean/std of its top-k cohort scores, on ``device``
    (default ``cuda``). The trial side runs in ``block_rows`` blocks so the
    (N, C) score matrix never exists whole. A cohort smaller than ``topk``
    means "use the whole cohort"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("cohort scoring needs float32 matmuls; "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    topk = min(topk, len(cohort_matrix))
    c = torch.as_tensor(np.asarray(cohort_matrix, np.float32), device=dev)
    means, stds = [], []
    for lo in range(0, len(trial_matrix), block_rows):
        t = torch.as_tensor(
            np.asarray(trial_matrix[lo: lo + block_rows], np.float32), device=dev)
        top = torch.topk(t @ c.T, topk, dim=1).values
        means.append(top.mean(dim=1).cpu().numpy().astype(np.float64))
        stds.append(top.std(dim=1, correction=0).cpu().numpy().astype(np.float64))
    return np.concatenate(means), np.concatenate(stds)


def asnorm_scores(
    xvectors: Dict[str, np.ndarray],
    cohort: Dict[str, np.ndarray],
    trials: Sequence[Tuple[int, str, str]],
    raw_scores: np.ndarray,
    topk: int = 400,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """Adaptive symmetric s-norm of precomputed cosine scores:
    0.5 * ((s - m1)/sd1 + (s - m2)/sd2)."""
    trial_matrix, i1, i2 = _trial_index(xvectors, trials)
    cohort_matrix = np.stack(list(cohort.values())).astype(np.float32)
    mean, std = cohort_stats(trial_matrix, cohort_matrix, topk=topk, device=device)
    sc = np.asarray(raw_scores, np.float64)
    return 0.5 * ((sc - mean[i1]) / std[i1] + (sc - mean[i2]) / std[i2])


def write_scores(path: str, trials, scores) -> None:
    with open(path, "w") as f:
        for (_, u1, u2), sc in zip(trials, scores):
            print(u1, u2, sc, file=f)
