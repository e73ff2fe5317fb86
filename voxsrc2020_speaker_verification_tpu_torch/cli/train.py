"""Train a speaker-embedding model with the PyTorch port (feature-fed).

    # throughput run without data, on the GPU (the default device):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_vox2_dev_aug --model res2net50_w8_s6_c16 \\
        --synthetic --max-steps 50 --no-checkpoint

    # the plain PyTorch path on the CPU (small shapes):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_vox2_dev_aug --synthetic --device cpu \\
        --batch-size 4 --num-accumulation-steps 2 --feat-length 32 \\
        --max-steps 2 --no-checkpoint

Only the ``--synthetic`` feed is ported. Kaldi feature shards, the native
C++ feeder and raw-audio training raise and are listed in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import os

from ..recipes import RECIPES, get_recipe


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    p.add_argument("--model", default=None, help="model id override")
    p.add_argument("--exp-root", default="exp")
    p.add_argument("--synthetic", action="store_true",
                   help="random data, no IO (throughput runs)")
    p.add_argument("--raw", action="store_true",
                   help="raw-audio mode (not ported yet)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--save-every-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    # config overrides
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-accumulation-steps", type=int, default=None)
    p.add_argument("--total-epochs", type=int, default=None)
    p.add_argument("--margin", type=float, default=None)
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--feat-length", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--dataset-length", type=int, default=None)
    p.add_argument("--remat", action="store_true", default=None,
                   help="per-block rematerialization (not ported yet)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from .. import resolve_device
    device = resolve_device(args.device)
    if args.raw or not args.synthetic:
        raise NotImplementedError(
            "only --synthetic training is ported; feature shards, the native "
            "feeder and raw audio are queued in ROADMAP.md")

    overrides = {k: v for k, v in {
        "batch_size": args.batch_size,
        "num_accumulation_steps": args.num_accumulation_steps,
        "total_epochs": args.total_epochs,
        "margin": args.margin,
        "scale": args.scale,
        "feat_length": args.feat_length,
        "base_lr": args.base_lr,
        "dataset": args.dataset,
        "num_classes": args.num_classes,
        "dataset_length": args.dataset_length,
        "remat": args.remat,
    }.items() if v is not None}
    overrides.update(exp_root=args.exp_root, seed=args.seed)
    config, resume_from = get_recipe(args.recipe, model=args.model, **overrides)
    if resume_from is not None and resume_from.startswith("exp/"):
        resume_from = os.path.join(args.exp_root, *resume_from.split("/")[1:])

    from ..data.dataset import BatchFeeder, SyntheticDataset
    from ..training.loop import fit

    sources = [SyntheticDataset(config.feat_dim, config.feat_length,
                                config.num_classes, seed=args.seed + i)
               for i in range(4)]
    feeder = BatchFeeder(sources, config.batch_size, config.num_accumulation_steps).start()
    try:
        result = fit(config, feeder, resume_from=resume_from,
                     log_every=args.log_every, max_steps=args.max_steps,
                     checkpoint=not args.no_checkpoint,
                     save_every_steps=args.save_every_steps, device=device)
        print(f"done: {result.steps_run} steps, "
              f"{result.audio_seconds_per_second:.0f} audio-s/s")
    finally:
        feeder.stop()


if __name__ == "__main__":
    main()
