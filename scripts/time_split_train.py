#!/usr/bin/env python3
"""Time the stride-1 Res2Net split chain in training and the bench training
step on a GPU, through public entry points only, so that the same file
times another tree of the repository (copy it into that tree's
``scripts/``):

    python3 scripts/time_split_train.py [--label L] [--save OUT.json]
        [--chain-reps 10] [--steps 3] [--shapes bench|w24|all] [--route conv]
        [--skip-step]

1. The chain, forward and forward + backward, at the bench step's four
   stride-1 stage shapes (res2net50_w8_s6_c16, B=256, 200 frames, bn_groups
   8) and one w24-family stage (128 x 96 x 200 x 80, w 24, s 4), through
   ``models.res2net.Res2NetSplitConv`` in training (bf16 input, float32
   parameters): CUDA-event milliseconds (median of ``--chain-reps``), and
   the device time of one forward + backward by kernel name
   (torch.profiler).
   ``--shapes w24`` times res2net200_att's four stride-1 stages instead
   (B=128, 200 frames: w = 24, 48, 96, 192, s 4), ``--shapes all`` the
   bench's four and those four in one call; ``--route conv`` times
   the chain through F.conv2d + K5 + adds + cat
   (``models.res2net._split_chain_span`` without a mesh, the route before
   K9 / K9b; this tree only).
2. The resident bench step (``training.trainer.make_train_step`` on one
   resident batch of B=256 x A=4 x 200 frames, bf16): CUDA-event ms of
   ``--steps`` steps after a warm-up, and its device time by kernel name
   over one step (the 25 largest).

Prints one JSON line (and writes it to ``--save``) with the card's name and
power limit. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (x shape, width, split)
SHAPES = {"bench": (((256, 48, 200, 80), 8, 6), ((256, 96, 100, 40), 16, 6),
                    ((256, 192, 50, 20), 32, 6), ((256, 384, 25, 10), 64, 6),
                    ((128, 96, 200, 80), 24, 4)),
          "w24": (((128, 96, 200, 80), 24, 4), ((128, 192, 100, 40), 48, 4),
                  ((128, 384, 50, 20), 96, 4), ((128, 768, 25, 10), 192, 4))}
SHAPES["all"] = SHAPES["bench"][:4] + SHAPES["w24"]
GROUPS = 8


def events_ms(fn, reps):
    """Median CUDA-event milliseconds of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_by_kernel(fn, calls=1, top=25):
    """(device ms of one call, {kernel name: device ms of one call}) by
    torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {e.key: e.device_time_total / calls / 1e3 for e in prof.key_averages()
          if e.device_type.name == "CUDA" and not e.key.startswith("Command Buffer")}
    total = sum(by.values())
    return total, dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])


def chain_times(dev, reps, shapes="bench"):
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import Res2NetSplitConv

    rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    for shape, w, s in SHAPES[shapes]:
        mod = Res2NetSplitConv(s, w, 1).to(dev)
        with torch.no_grad():
            mod.weight.normal_(0.0, (9 * w) ** -0.5, generator=g)
        for i in range(s - 1):
            getattr(mod, f"bn{i}").groups = GROUPS
        x = torch.randn(shape, generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last)
        dy = torch.randn(shape, generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last)
        xi = x.detach().requires_grad_(True)

        def fwd():
            with torch.no_grad():
                mod(x, True)

        def fwd_bwd():
            y = mod(xi, True)
            torch.autograd.grad(y, [xi, mod.weight], dy)

        fwd_ms, step_ms = events_ms(fwd, reps), events_ms(fwd_bwd, reps)
        dev_ms, by = device_by_kernel(fwd_bwd, calls=3, top=12)
        rows.append(dict(shape=list(shape), width=w, split=s, ms_fwd=fwd_ms, ms_fwd_bwd=step_ms,
                         device_ms_fwd_bwd=dev_ms, device_ms_by_kernel=by))
        del x, dy, xi, mod
        torch.cuda.empty_cache()
    return rows


def step_times(dev, steps):
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        create_train_state, make_train_step)

    config, _ = get_recipe("res2net_vox2_dev_aug", model="res2net50_w8_s6_c16", batch_size=256,
                           num_accumulation_steps=4, feat_length=200)
    state = create_train_state(config, dev)
    step = make_train_step(config)
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(4, 256, 200, config.feat_dim, generator=g, device=dev)
    labels = torch.randint(0, config.num_classes, (4, 256), generator=g, device=dev)
    box = [state]

    def run():
        box[0], _ = step(box[0], feats, labels)

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    dev_ms, by = device_by_kernel(run, calls=1)
    return dict(bn_groups=config.bn_groups, step_ms=times, step_ms_median=statistics.median(times),
                peak_memory_bytes=peak, device_ms=dev_ms, device_ms_by_kernel=by)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--label", default="")
    p.add_argument("--save", default=None)
    p.add_argument("--chain-reps", type=int, default=10)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--skip-step", action="store_true", help="time the chains only")
    p.add_argument("--shapes", choices=sorted(SHAPES), default="bench")
    p.add_argument("--route", choices=("kernels", "conv"), default="kernels",
                   help="conv: the chain through F.conv2d + K5 + adds + cat")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_split_train: no CUDA device", file=sys.stderr)
        return 2
    from voxsrc2020_speaker_verification_tpu_torch import set_float32_precision

    set_float32_precision()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    if args.route == "conv":
        from voxsrc2020_speaker_verification_tpu_torch.models import res2net

        res2net.split_chain_train = res2net._split_chain_span
    out = {"label": args.label, "nvidia_smi": smi, "torch": torch.__version__,
           "shapes": args.shapes, "route": args.route,
           "chains": chain_times(dev, args.chain_reps, args.shapes)}
    if not args.skip_step:
        out["step"] = step_times(dev, args.steps)
    line = json.dumps(out)
    print(line, flush=True)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
