"""Migrate a reference TensorFlow-1.x checkpoint into an experiment
directory of the port; the JAX package's ``cli/import_checkpoint.py``.

The reference publishes trained checkpoints (ref README.md:131,164, e.g.
``res2net50_w24_s4_c32_..._8GPUs_5994_122636``); this converts one into a
checkpoint of ``training/checkpoint.py`` that every surface of the port
reads: resumed training (``cli.train`` resumes from the experiment dir, the
LMFT leg included), ``cli.export``, ``cli.extract`` and ``cli.serve``:

    python -m voxsrc2020_speaker_verification_tpu_torch.cli.import_checkpoint \\
        --ckpt /path/to/model.ckpt-122636 \\
        --model res2net50_w24_s4_c32 --projection sc_cm_linear \\
        --num-classes 5994 --exp-dir exp/voxceleb2_dev_aug/<name>

``--ckpt`` is read by ``utils/tf_bundle.py`` (no TensorFlow); ``--npz``
takes ``{tf_var_name: array}`` (the oracle-dump format). The name map (TF1
auto-uniquified scopes -> module paths) is ``utils/tf_import.py``.

Momentum slots: ``<var>/Momentum`` (and ``<var>/Momentum:0``) slots in the
checkpoint become the state's momentum, so a resumed run continues the
optimizer trace; without slots momentum starts at zero. The step is
``--step``, else the checkpoint's ``global_step``, else 0. ``config.json``
is written beside the checkpoint. The state is built on ``--device``
(default ``cuda``; ``cpu`` asks for the CPU) before it is saved.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="TF checkpoint prefix (<prefix>.index and its data "
                                    "shards; read without TensorFlow)")
    src.add_argument("--npz", help="npz of {tf_var_name: array} (oracle-dump format)")
    p.add_argument("--model", required=True)
    p.add_argument("--projection", default="sc_cm_linear")
    p.add_argument("--num-classes", type=int, default=5994)
    p.add_argument("--num-centers", type=int, default=2)
    p.add_argument("--exp-dir", required=True, help="output experiment dir")
    p.add_argument("--step", type=int, default=None,
                   help="global step to record; default: the checkpoint's global_step "
                        "(the LMFT resume keys its schedules off it)")
    p.add_argument("--recipe", default=None,
                   help="recipe to derive <exp-dir>/config.json from; without it a config "
                        "with the given model/projection/num-classes and defaults")
    p.add_argument("--feat-dim", type=int, default=None,
                   help="feature dimensionality for config.json (default: the recipe's, or "
                        "80); MUST match what the checkpoint was trained on")
    p.add_argument("--device", default=None,
                   help="device the state is built on (default cuda; 'cpu' asks for the CPU)")
    return p


def load_snapshot(args) -> dict:
    if args.npz:
        data = np.load(args.npz)
        return {k: data[k] for k in data.files}
    from ..utils.tf_import import load_tf_checkpoint
    return load_tf_checkpoint(args.ckpt, verbose=True)


def momentum_slots(snapshot: dict) -> dict:
    """``{var: slot}`` of the ``<var>/Momentum`` slots (``<var>:0`` for
    ``<var>/Momentum:0`` of oracle dumps)."""
    slots = {}
    for k, v in snapshot.items():
        if k.endswith("/Momentum"):
            slots[k[: -len("/Momentum")]] = v
        elif k.endswith("/Momentum:0"):
            slots[k[: -len("/Momentum:0")] + ":0"] = v
    return slots


def snapshot_step(snapshot: dict) -> int:
    for key in ("global_step", "global_step:0"):
        if key in snapshot:
            return int(np.asarray(snapshot[key]))
    return 0


def main(argv=None) -> str:
    """Returns the experiment dir."""
    from .. import set_float32_precision
    set_float32_precision()
    args = build_parser().parse_args(argv)
    snapshot = load_snapshot(args)

    from ..config import TrainConfig
    from ..convert import train_state_from_flax
    from ..recipes import get_recipe
    from ..training.checkpoint import CheckpointManager
    from ..utils.tf_import import import_reference_weights

    params, batch_stats = import_reference_weights(snapshot, args.model,
                                                   projection_id=args.projection)
    slots = momentum_slots(snapshot)
    if slots:
        momentum, _ = import_reference_weights(slots, args.model, projection_id=args.projection,
                                               params_only=True)
    else:
        momentum = _zeros_like_tree(params)
    step = args.step if args.step is not None else snapshot_step(snapshot)

    if args.recipe:
        config, _ = get_recipe(args.recipe, model=args.model)
        config = dataclasses.replace(
            config, projection=args.projection, num_classes=args.num_classes,
            num_centers=args.num_centers,
            **({"feat_dim": args.feat_dim} if args.feat_dim is not None else {}))
    else:
        config = TrainConfig(model=args.model, projection=args.projection,
                             num_classes=args.num_classes, num_centers=args.num_centers,
                             feat_dim=args.feat_dim if args.feat_dim is not None else 80)
    state = train_state_from_flax(step, params, batch_stats, momentum, config=config,
                                  device=args.device)
    n_params = sum(p.numel() for p in state.net.parameters())
    mgr = CheckpointManager(args.exp_dir)
    mgr.save(state, step=step)
    # config.json makes the dir self-describing for cli.export / evaluate / serve
    config.to_json(os.path.join(args.exp_dir, "config.json"))
    print(f"imported {args.model} ({n_params / 1e6:.1f}M params, "
          f"{'with' if slots else 'zero'} momentum) at step {step} -> {args.exp_dir}")
    return args.exp_dir


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return np.zeros(np.shape(tree), np.float32)


if __name__ == "__main__":
    main()
