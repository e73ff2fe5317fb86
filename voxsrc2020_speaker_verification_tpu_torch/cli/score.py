"""Trial scoring CLI: cosine / adaptive s-norm, then EER and minDCF.

The reference's snorm.py + eer_minDCF.py invocations
(eval_inference_model.sh:42-60), as the JAX package's ``cli/score.py``:

    python -m voxsrc2020_speaker_verification_tpu_torch.cli.score \\
        --trials data/trials/list_T --xvectors data/voxceleb1/xvector.scp \\
        --cohort-xvectors data/voxceleb2_dev/xvector.scp \\
        --cohort-spk2utt data/voxceleb2_dev/spk2utt --out scores_T.txt

Cohorts (ref snorm.py:45-81): per-speaker means of a cohort set's
embeddings (``--cohort-xvectors`` + ``--cohort-spk2utt``), or the exported
projection rows (``--cohort-weights projection_weight.pkl``). Omit both for
cosine scoring alone. The cohort's top-k statistics run on ``--device``
(default ``cuda``).
"""

from __future__ import annotations

import argparse
import pickle
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trials", required=True)
    p.add_argument("--xvectors", required=True, help="test xvector scp")
    p.add_argument("--cohort-xvectors", default=None)
    p.add_argument("--cohort-spk2utt", default=None)
    p.add_argument("--cohort-weights", default=None,
                   help="projection_weight.pkl (classifier rows as cohort)")
    p.add_argument("--topk", type=int, default=400)
    p.add_argument("--p-target", type=float, default=0.01)
    p.add_argument("--out", default=None, help="write '<utt1> <utt2> <score>' lines")
    p.add_argument("--device", default=None,
                   help="device of the cohort statistics (default cuda; 'cpu' asks for the CPU)")
    return p


def load_cohort(weights: str = None, xvectors: str = None, spk2utt: str = None):
    """The asnorm cohort: projection rows (``weights``), or the speaker means
    of a cohort set's embeddings; None without either."""
    from ..data import kaldi_io
    from ..eval.scoring import speaker_means
    from ..utils import datadir

    if weights:
        with open(weights, "rb") as f:
            w = np.asarray(pickle.load(f), np.float32)
        return {i: row for i, row in enumerate(w)}
    if xvectors:
        raw = dict(kaldi_io.read_vec_flt_scp(xvectors))
        return speaker_means(raw, datadir.read_spk2utt(spk2utt))
    return None


def main(argv=None):
    """Prints and returns (mode, EER %, minDCF); EER and minDCF are None
    for trials without labels."""
    from .. import set_float32_precision
    set_float32_precision()
    args = build_parser().parse_args(argv)
    if args.cohort_xvectors and not args.cohort_spk2utt:
        sys.exit("cli.score: --cohort-spk2utt required with --cohort-xvectors")

    from .. import resolve_device
    from ..data import kaldi_io
    from ..eval.metrics import evaluate_trials
    from ..eval.scoring import (asnorm_scores, cosine_scores, l2norm, read_trials,
                                write_scores)

    device = resolve_device(args.device)
    trials = read_trials(args.trials)
    # ref snorm.py:28-33: normalize on read
    xvec = {utt: l2norm(vec) for utt, vec in kaldi_io.read_vec_flt_scp(args.xvectors)}
    scores = cosine_scores(xvec, trials)
    mode = "cosine"
    cohort = load_cohort(args.cohort_weights, args.cohort_xvectors, args.cohort_spk2utt)
    if cohort is not None:
        scores = asnorm_scores(xvec, cohort, trials, scores, topk=args.topk, device=device)
        mode = f"asnorm-top{args.topk}"
    if args.out:
        write_scores(args.out, trials, scores)

    labels = np.array([t[0] for t in trials])
    if (labels >= 0).all():
        eer_pct, min_dcf = evaluate_trials(trials, scores, p_target=args.p_target)
        print(f"{mode}: EER {eer_pct:.4f}%  minDCF(p={args.p_target}) {min_dcf:.4f}")
        return mode, eer_pct, min_dcf
    print(f"{mode}: scored {len(trials)} trials (no labels)")
    return mode, None, None


if __name__ == "__main__":
    main()
