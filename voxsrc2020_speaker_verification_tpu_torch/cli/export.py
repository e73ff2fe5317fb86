"""Export a trained checkpoint to an inference artifact.

The reference's export_inference_model.sh (:29-49) and the JAX package's
``cli/export.py``:

    python -m voxsrc2020_speaker_verification_tpu_torch.cli.export \\
        --exp-dir exp/voxceleb2_dev_aug/<exp name> [--out <exp>/artifact]

Restores a checkpoint of the experiment dir (``training/checkpoint.py``; the
latest unless ``--step``) into a training state built from the dir's
``config.json`` (written by training; ``--recipe``/``--model`` where there is
none) and writes ``config.json``, ``weights.pt`` and
``projection_weight.pkl`` (``eval/export.py``). ``--stablehlo`` (the JAX
package's serialized embed functions) has no counterpart in the port and
exits with an error; ``--batch-size``, which sizes those functions in the
JAX package, is accepted and has no effect here.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--recipe", default=None,
                   help="recipe name; not needed when <exp-dir>/config.json exists "
                        "(written by training)")
    p.add_argument("--model", default=None)
    p.add_argument("--exp-dir", default=None,
                   help="experiment dir (default: the recipe's exp_dir)")
    p.add_argument("--step", type=int, default=None, help="checkpoint step (default latest)")
    p.add_argument("--out", default=None, help="artifact dir (default <exp-dir>/artifact)")
    p.add_argument("--batch-size", type=int, default=32,
                   help="the JAX package's --stablehlo bucket batch; accepted so its command "
                        "lines run unchanged (the port's artifact has no batch shape)")
    p.add_argument("--stablehlo", action="store_true",
                   help="not ported: the JAX package's serialized StableHLO embed functions")
    p.add_argument("--device", default=None,
                   help="device the state is restored on (default cuda; 'cpu' asks for the CPU)")
    return p


def main(argv=None) -> str:
    """Returns the artifact dir."""
    from .. import set_float32_precision
    set_float32_precision()
    args = build_parser().parse_args(argv)
    if args.stablehlo:
        sys.exit("cli.export: --stablehlo is not ported: the port's artifact is "
                 "config.json + weights.pt (ROADMAP.md, 'not ported')")

    from .. import resolve_device
    from ..config import TrainConfig
    from ..eval.export import export_inference_artifact
    from ..recipes import get_recipe
    from ..training.checkpoint import CheckpointManager
    from ..training.trainer import create_train_state

    device = resolve_device(args.device)
    config = None
    if args.recipe:
        config, _ = get_recipe(args.recipe, model=args.model)
    exp_dir = args.exp_dir or (config.exp_dir if config else None)
    if not exp_dir:
        sys.exit("cli.export: --exp-dir or --recipe required")
    # the exp dir's own config (written by training) wins: it carries the CLI
    # overrides the recipe preset does not know about
    cfg_json = os.path.join(exp_dir, "config.json")
    if os.path.exists(cfg_json):
        config = TrainConfig.from_json(cfg_json)
    if config is None:
        sys.exit(f"cli.export: no {cfg_json}; pass --recipe")
    out = args.out or os.path.join(exp_dir, "artifact")

    state = create_train_state(config, device)
    if CheckpointManager(exp_dir).restore(state, step=args.step) is None:
        sys.exit(f"cli.export: no checkpoint in {exp_dir}")
    path = export_inference_artifact(config, state, out)
    print(f"artifact at {path} (step {int(state.step)})")
    return path


if __name__ == "__main__":
    main()
