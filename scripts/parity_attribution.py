#!/usr/bin/env python3
"""Where a float32 training step on the GPU strays from the float64 step: one
step of a thin variant of an encoder family (``chip_smoke.py``'s thin
variants, the train_parity configuration: sc_cm_linear head, bn_groups 2,
200 frames, step 4 epochs in) from the same weights and batch, on the card
with the port's kernels, on the card with kernels swapped for their plain
PyTorch versions, and on the CPU in float32, each against the CPU's float64
step.

    python3 scripts/parity_attribution.py [--models ecapa_thin_smoke dpn_thin_smoke]
                                          [--batches 16 64]

Prints one JSON line a (model, batch, variant): the parameter update's
relative L2 distance to the float64 step's, and the two parameters that
carry most of it. Variants: ``kernels``; ``plain_<name>`` with one wrapper
(``bn_train``, ``stats_pool``, ``att_pool``, ``margin_ce``) replaced by its
plain version on the card; ``plain_all`` with all four; ``cpu``. Then one
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch import kernels  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.losses import projections  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state, make_train_step)

WRAPPERS = {"bn_train": ops, "stats_pool": ops, "att_pool": ops, "margin_ce": projections}


def step_update(model, batch, device, dtype):
    """The parameter update of one step, float64 on the CPU, by name."""
    config = TrainConfig(model=model, bf16=False, batch_size=batch, num_accumulation_steps=1,
                         bn_groups=2, feat_length=chip_smoke.TRAIN_FRAMES, seed=chip_smoke.SEED)
    rng = np.random.RandomState(chip_smoke.SEED + 7)
    feats = torch.from_numpy(rng.randn(1, batch, config.feat_length, config.feat_dim)
                             .astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, config.num_classes, (1, batch)))
    state = create_train_state(config, device, seed=chip_smoke.SEED + 3)
    state.net.to(dtype)
    state.net.encoder.dtype = dtype
    state.momentum = {k: v.to(dtype) for k, v in state.momentum.items()}
    state.step = 4 * config.epoch_size
    before = {k: v.detach().cpu().double().clone() for k, v in state.params.items()}
    state, _ = make_train_step(config)(state, feats.to(device), labels.to(device))
    return {k: state.params[k].detach().cpu().double() - b for k, b in before.items()}


def distance(update, ref):
    err = torch.cat([(update[k] - ref[k]).flatten() for k in ref]).norm()
    top = sorted(((float((update[k] - ref[k]).norm()), k) for k in ref), reverse=True)[:2]
    return float(err / torch.cat([v.flatten() for v in ref.values()]).norm()), top


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+", default=["ecapa_thin_smoke", "dpn_thin_smoke"])
    p.add_argument("--batches", type=int, nargs="+", default=[16, 64])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("parity_attribution: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kernels.build_all()
    chip_smoke.register_thin_variants()
    dev = torch.device("cuda")
    variants = [("kernels", ())] + [(f"plain_{n}", (n,)) for n in WRAPPERS] + [
        ("plain_all", tuple(WRAPPERS))]
    for model in args.models:
        for batch in args.batches:
            ref = step_update(model, batch, torch.device("cpu"), torch.float64)
            for name, swapped in variants:
                saved = {n: getattr(WRAPPERS[n], n) for n in swapped}
                try:
                    for n in swapped:
                        setattr(WRAPPERS[n], n, getattr(WRAPPERS[n], n + "_reference"))
                    update = step_update(model, batch, dev, torch.float32)
                finally:
                    for n, fn in saved.items():
                        setattr(WRAPPERS[n], n, fn)
                err, top = distance(update, ref)
                print(json.dumps({"model": model, "batch": batch, "variant": name,
                                  "update_rel_err_vs_float64": err, "largest": top}), flush=True)
            err, top = distance(step_update(model, batch, torch.device("cpu"), torch.float32), ref)
            print(json.dumps({"model": model, "batch": batch, "variant": "cpu",
                              "update_rel_err_vs_float64": err, "largest": top}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
