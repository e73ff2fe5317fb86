"""One-shot evaluation: extract test and cohort embeddings, score every trial
list, print EER and minDCF; the JAX package's ``cli/evaluate.py`` on the GPU.

The reference's eval_inference_model.sh (:27-60) orchestration (per-GPU
extraction shards + snorm.py + eer_minDCF.py per trial set):

    # from an experiment dir (exports an inference artifact if needed):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.evaluate \\
        --exp-dir exp/voxceleb2_dev_aug/<exp name> \\
        --data-root data --trials T E H --asnorm

    # from an existing artifact with explicit paths:
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.evaluate \\
        --artifact exp/.../artifact \\
        --test-dir data/voxceleb1 --cohort-dir data/voxceleb2_dev \\
        --trials T=data/voxceleb1_trials/list_test_T.txt

Bare trial names T/E/H resolve to ``<data-root>/voxceleb1_trials/
list_test_<NAME>.txt`` (ref prepare_data.sh:205-210). ``--asnorm`` scores
adaptive s-norm against the ``<data-root>/voxceleb2_dev`` speaker-mean
cohort; ``--cohort-dir`` names another cohort set, ``--cohort-weights`` the
exported classifier rows. For the VoxSRC2022-dev protocol pass the trial
list and ``--p-target 0.05`` (ref README.md:278). Extraction and the cohort
statistics run on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", default=None, help="inference artifact dir (cli.export output)")
    src.add_argument("--exp-dir", default=None,
                     help="experiment dir; uses <exp-dir>/artifact, exporting it from the "
                          "latest checkpoint if absent")
    p.add_argument("--data-root", default="data",
                   help="data root for bare --trials names, the default --test-dir and "
                        "the --asnorm cohort")
    p.add_argument("--test-dir", default=None, help="test data dir (default <data-root>/voxceleb1)")
    p.add_argument("--asnorm", action="store_true",
                   help="also score adaptive s-norm against the <data-root>/voxceleb2_dev "
                        "speaker-mean cohort")
    p.add_argument("--cohort-dir", default=None)
    p.add_argument("--cohort-weights", default=None)
    p.add_argument("--trials", nargs="+", required=True,
                   help="NAME=path entries, or bare T/E/H names resolved under "
                        "<data-root>/voxceleb1_trials/")
    p.add_argument("--batch-size", type=int, default=None, help="extraction bucket batch")
    p.add_argument("--topk", type=int, default=400)
    p.add_argument("--p-target", type=float, default=0.01,
                   help="minDCF operating point (0.01 for VoxCeleb1 T/E/H, 0.05 for "
                        "VoxSRC2022-dev, ref README.md:278)")
    p.add_argument("--out-dir", default=None,
                   help="where to write xvectors (default: the data dirs)")
    p.add_argument("--num-devices", type=int, default=0,
                   help="extraction's cards (cli.extract --num-devices: 0 = every local "
                        "card, one on --device cpu)")
    p.add_argument("--wire", choices=("float32", "bfloat16"), default="float32",
                   help="host-to-device feature wire for extraction (cli.extract --wire)")
    p.add_argument("--cmvn", choices=("device", "host"), default="device",
                   help="where extraction's sliding CMVN runs (cli.extract --cmvn)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    return p


def resolve_artifact(args) -> str:
    """--artifact as given; --exp-dir uses or creates <exp-dir>/artifact."""
    if args.artifact:
        return args.artifact
    artifact = os.path.join(args.exp_dir, "artifact")
    if not os.path.exists(os.path.join(artifact, "config.json")):
        from .export import main as export_main

        print(f"exporting {artifact} from the latest checkpoint ...")
        argv = ["--exp-dir", args.exp_dir, "--out", artifact]
        export_main(argv + (["--device", str(args.device)] if args.device else []))
    return artifact


def resolve_trials(entry: str, data_root: str):
    """(name, path) of a --trials entry: NAME=path, a bare path, or a bare
    trial-set name under <data-root>/voxceleb1_trials/."""
    name, _, path = entry.partition("=")
    if not path:
        path = name if os.path.exists(name) else os.path.join(
            data_root, "voxceleb1_trials", f"list_test_{name}.txt")
    return name, path


def main(argv=None):
    """Prints one line per trial set; returns {name: {"cosine": (EER %,
    minDCF), "asnorm": (EER %, minDCF) with a cohort}}."""
    from .. import set_float32_precision
    set_float32_precision()
    args = build_parser().parse_args(argv)

    from .. import resolve_device
    from ..data import kaldi_io
    from ..eval.metrics import evaluate_trials
    from ..eval.scoring import asnorm_scores, cosine_scores, l2norm, read_trials
    from ..eval.extract import extraction_devices
    from .extract import extract_dataset
    from .score import load_cohort

    device = resolve_device(args.device)
    devices = extraction_devices(args.num_devices, device)
    artifact = resolve_artifact(args)
    test_dir = args.test_dir or os.path.join(args.data_root, "voxceleb1")
    cohort_dir = args.cohort_dir
    if args.asnorm and not cohort_dir and not args.cohort_weights:
        cohort_dir = os.path.join(args.data_root, "voxceleb2_dev")

    def xvector_scp(data_dir):
        """The data set's xvector scp, extracted unless it exists: inside the
        data dir, or with --out-dir under it, named by the data dir's
        basename so the test and cohort sets never collide."""
        if args.out_dir:
            base = os.path.basename(os.path.normpath(data_dir))
            prefix = os.path.join(args.out_dir, f"xvector_{base}")
        else:
            prefix = os.path.join(data_dir, "xvector")
        scp = prefix + ".scp"
        if not os.path.exists(scp):
            print(f"extracting {data_dir} ...")
            os.makedirs(os.path.dirname(prefix), exist_ok=True)
            scp = extract_dataset(artifact, data_dir, prefix, batch_size=args.batch_size,
                                  devices=devices, wire=args.wire,
                                  cmvn=args.cmvn, device=device)
        return scp

    xvec = {u: l2norm(v) for u, v in kaldi_io.read_vec_flt_scp(xvector_scp(test_dir))}
    cohort = None
    if args.cohort_weights:
        cohort = load_cohort(weights=args.cohort_weights)
    elif cohort_dir:
        cohort = load_cohort(xvectors=xvector_scp(cohort_dir),
                             spk2utt=os.path.join(cohort_dir, "spk2utt"))

    results = {}
    for entry in args.trials:
        name, path = resolve_trials(entry, args.data_root)
        trials = read_trials(path)
        scores = cosine_scores(xvec, trials)
        eer, dcf = evaluate_trials(trials, scores, p_target=args.p_target)
        results[name] = {"cosine": (eer, dcf)}
        line = f"[{name}] cosine: EER {eer:.4f}% minDCF {dcf:.4f}"
        if cohort is not None:
            s2 = asnorm_scores(xvec, cohort, trials, scores, topk=args.topk, device=device)
            eer2, dcf2 = evaluate_trials(trials, s2, p_target=args.p_target)
            results[name]["asnorm"] = (eer2, dcf2)
            line += f" | asnorm: EER {eer2:.4f}% minDCF {dcf2:.4f}"
        print(line)
    return results


if __name__ == "__main__":
    main()
