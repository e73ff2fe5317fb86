#!/usr/bin/env python3
"""Peak device memory and step time of one training step of each encoder
family at full width, on one GPU: which microbatch (and which
rematerialized stages) the card holds at a recipe's shape.

    python3 scripts/encoder_memory.py [--only dpn68] [--save out.json]
    python3 scripts/encoder_memory.py --single-chip [--only MODEL] [--save out.json]

Each case (model, recipe, microbatch, remat stages): the recipe's config at
that microbatch with A = 1 (bf16, its bn_groups, margin head and frames),
seeded weights, synthetic features; two steps (the first grows the
allocator's pool), the second timed by the host clock after a synchronize;
peak memory by ``torch.cuda.max_memory_allocated`` over both. A case that
runs out of memory is reported as such and the next one runs. Prints one
JSON line a case, then one with the card's name and power limit.

``--single-chip`` measures the shapes of ``recipes.SINGLE_CHIP_SHAPES``
instead: for each (model, frames) key of the JAX package's single-chip
table, microbatches from the largest down (A = 1024 / B), each without
rematerialization and, where that runs out of memory or leaves less than
10% of the card free, with stages 0-2 rematerialized, until two shapes fit
without rematerialization (or the list ends);
bn_groups keeps a BN group at 32 rows (f200), 16 (f600) or 128 (the TDNN's
f320), as the JAX table does. It then picks each key's row: the most rows
per second among the shapes whose peak leaves 10% of the card's memory
free, and prints it (and saves it with ``--save``) as the table's source.
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

from voxsrc2020_speaker_verification_tpu_torch import (  # noqa: E402
    kernels, set_float32_precision)
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


# (model, recipe, microbatches to try, largest first) of each key of the
# single-chip table (JAX recipes/__init__.py:171-223)
SINGLE_CHIP_KEYS = (
    ("res2net50_w8_s6_c16", "res2net_vox2_dev_aug", (512, 256, 128, 64)),
    ("res2net50_w8_s6_c16", "res2net_finetune_vox2_dev", (256, 128, 64, 32)),
    ("res2net50_w24_s4_c64", "res2net_vox2_dev_aug", (256, 128, 64, 32)),
    ("res2net50_w24_s4_c64", "res2net_finetune_vox2_dev", (256, 128, 64, 32)),
    ("res2net50_w24_s4_c32", "res2net_vox2_dev_aug", (256, 128, 64, 32)),
    ("res2net50_w24_s4_c32", "res2net_finetune_vox2_dev", (256, 128, 64, 32)),
    ("res2net101_w24_s4_c32_att", "res2net_vox2_dev_aug", (256, 128, 64, 32)),
    ("res2net101_w24_s4_c32_att", "res2net_finetune_vox2_dev", (128, 64, 32, 16)),
    ("res2net152_w24_s4_c32_att", "res2net_vox2_dev_aug", (256, 128, 64, 32)),
    ("res2net152_w24_s4_c32_att", "res2net_finetune_vox2_dev", (128, 64, 32, 16)),
    ("res2net200_w24_s4_c32_att", "res2net_vox2_dev_aug", (256, 128, 64, 32)),
    ("res2net200_w24_s4_c32_att", "res2net_finetune_vox2_dev", (128, 64, 32, 16)),
    ("dpn68", "dpn_vox2_dev_aug", (256, 128, 64, 32)),
    ("dpn68", "dpn_finetune_vox2_dev", (256, 128, 64, 32)),
    ("tdnn", "tdnn_voxsrc2020_vox2_dev_aug", (1024, 512, 256)),
)
EFFECTIVE_BATCH = 1024
REMAT_STAGES = (0, 1, 2)
HEADROOM = 0.10  # a row's peak leaves this share of the card's memory free


def group_rows(model: str, frames: int) -> int:
    """Rows of one BN group in the single-chip table (JAX
    recipes/__init__.py:161-170): 128 for the TDNN, 16 at 600 frames, else 32."""
    return 128 if model == "tdnn" else (16 if frames == 600 else 32)


def run_case(model, recipe, batch, stages, dev, bn_groups=None):
    overrides = dict(batch_size=batch, num_accumulation_steps=1)
    if stages:
        overrides.update(remat=True, remat_stages=stages)
    if bn_groups:
        overrides.update(bn_groups=bn_groups)
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


def single_chip_sweep(dev, only=None):
    """Every key's candidate shapes, and the row picked for each key."""
    limit = (1.0 - HEADROOM) * torch.cuda.get_device_properties(dev).total_memory
    cases, rows = [], []
    for model, recipe, batches in SINGLE_CHIP_KEYS:
        if only and model != only:
            continue
        fits, plain_fits = [], 0
        for batch in batches:
            frames = get_recipe(recipe, model=model)[0].feat_length
            groups = max(1, batch // group_rows(model, frames))
            for stages in (None, REMAT_STAGES):
                line = run_case(model, recipe, batch, stages, dev, groups)
                line["within_headroom"] = bool(line["fits"]
                                               and line["peak_memory_bytes"] <= limit)
                if line["within_headroom"]:
                    line["rows_per_s"] = batch / line["step_ms"] * 1e3
                print(json.dumps(line), flush=True)
                cases.append(line)
                if line["within_headroom"]:
                    fits.append(line)
                    plain_fits += stages is None
                    break  # remat only where the plain shape does not fit
                gc.collect()
                torch.cuda.empty_cache()
            if plain_fits == 2:
                break
        if fits:
            best = max(fits, key=lambda c: c["rows_per_s"])
            row = dict(model=model, frames=best["frames"], batch_size=best["microbatch"],
                       num_accumulation_steps=EFFECTIVE_BATCH // best["microbatch"],
                       remat=best["remat_stages"] is not None,
                       remat_stages=best["remat_stages"], bn_groups=best["bn_groups"],
                       peak_memory_bytes=best["peak_memory_bytes"],
                       microbatch_step_ms=best["step_ms"], rows_per_s=best["rows_per_s"])
            print(json.dumps({"row": row}), flush=True)
            rows.append(row)
    return cases, rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--only", default=None, help="only the cases of this model")
    p.add_argument("--save", default=None, help="also write the lines to this JSON file")
    p.add_argument("--single-chip", action="store_true",
                   help="measure the single-chip table's shapes and pick its rows")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("encoder_memory: needs a CUDA GPU", file=sys.stderr)
        return 2
    kernels.build_all()
    set_float32_precision()
    dev = torch.device("cuda")
    if args.single_chip:
        cases, rows = single_chip_sweep(dev, args.only)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        total = torch.cuda.get_device_properties(dev).total_memory
        print(json.dumps({"card": smi, "total_memory_bytes": total}), flush=True)
        if args.save:
            with open(args.save, "w") as f:
                json.dump({"card": smi, "total_memory_bytes": total, "headroom": HEADROOM,
                           "effective_batch": EFFECTIVE_BATCH, "rows": rows, "cases": cases},
                          f, indent=1)
        return 0
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
