#!/usr/bin/env python3
"""Peak device memory and step time of one training step of each encoder
family at full width, on one GPU: which microbatch (and which
rematerialized stages) the card holds at a recipe's shape.

    python3 scripts/encoder_memory.py [--only dpn68] [--save out.json]

Each case (model, recipe, microbatch, remat stages): the recipe's config at
that microbatch with A = 1 (bf16, its bn_groups, margin head and frames),
seeded weights, synthetic features; two steps (the first grows the
allocator's pool), the second timed by the host clock after a synchronize;
peak memory by ``torch.cuda.max_memory_allocated`` over both. A case that
runs out of memory is reported as such and the next one runs. Prints one
JSON line a case, then one with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxsrc2020_speaker_verification_tpu_torch import kernels  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state, make_train_step)

CASES = (
    ("res2net200_w24_s4_c32_att", "res2net_vox2_dev_aug", 256, None),
    ("res2net200_w24_s4_c32_att", "res2net_vox2_dev_aug", 128, None),
    ("res2net200_w24_s4_c32_att", "res2net_vox2_dev_aug", 128, (1, 2)),
    ("res2net200_w24_s4_c32_att", "res2net_vox2_dev_aug", 64, None),
    ("dpn68", "dpn_vox2_dev_aug", 256, None),
    ("dpn68", "dpn_vox2_dev_aug", 128, None),
    ("dpn68", "dpn_vox2_dev_aug", 256, (0,)),
    ("tdnn", "tdnn_voxsrc2020_vox2_dev_aug", 1024, None),
    ("ecapa_tdnn_512", "ecapa_vox2_dev_aug", 256, None),
)


def run_case(model, recipe, batch, stages, dev):
    overrides = dict(batch_size=batch, num_accumulation_steps=1)
    if stages:
        overrides.update(remat=True, remat_stages=stages)
    config, _ = get_recipe(recipe, model=model, **overrides)
    line = dict(model=model, recipe=recipe, microbatch=batch, remat_stages=stages,
                frames=config.feat_length, feat_dim=config.feat_dim, bn_groups=config.bn_groups)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        state = create_train_state(config, dev)
        step = make_train_step(config)
        g = torch.Generator(device=dev).manual_seed(0)
        feats = torch.randn((1, batch, config.feat_length, config.feat_dim), generator=g,
                            device=dev)
        labels = torch.randint(0, config.num_classes, (1, batch), generator=g, device=dev)
        state, m = step(state, feats, labels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, feats, labels)
        torch.cuda.synchronize()
        line.update(step_ms=1e3 * (time.perf_counter() - t0), loss=float(m["loss"]),
                    peak_memory_bytes=torch.cuda.max_memory_allocated(), fits=True)
    except torch.OutOfMemoryError:
        line.update(fits=False, peak_memory_bytes=torch.cuda.max_memory_allocated())
    return line


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--only", default=None, help="only the cases of this model")
    p.add_argument("--save", default=None, help="also write the lines to this JSON file")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("encoder_memory: needs a CUDA GPU", file=sys.stderr)
        return 2
    kernels.build_all()
    dev = torch.device("cuda")
    lines = []
    for model, recipe, batch, stages in CASES:
        if args.only and model != args.only:
            continue
        line = run_case(model, recipe, batch, stages, dev)
        print(json.dumps(line), flush=True)
        lines.append(line)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "total_memory_bytes":
                      torch.cuda.get_device_properties(dev).total_memory}), flush=True)
    if args.save:
        with open(args.save, "w") as f:
            json.dump({"card": smi, "cases": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
