#!/usr/bin/env python3
"""Time and profile training steps of the PyTorch port on a GPU.

    python3 scripts/profile_torch_train.py [--model res2net50_w8_s6_c16]
        [--batch 256] [--accum 4] [--frames 200] [--bn-groups 8] [--steps 3]

Builds the training state (``training.trainer.create_train_state``, seeded
weights, bf16 compute) and runs ``make_train_step`` on one resident batch
of synthetic features (no feeder: the device work alone). Prints one JSON
line: the median step time by CUDA events, the card's name and power limit,
peak device memory, the device time per kernel name (and calls per step)
from ``torch.profiler`` over ``--steps`` steps, and the share of the
profiled window the device was idle.
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

from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state, make_train_step)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="res2net50_w8_s6_c16")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--accum", type=int, default=4)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--bn-groups", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2

    config, _ = get_recipe("res2net_vox2_dev_aug", model=args.model, batch_size=args.batch,
                           num_accumulation_steps=args.accum, feat_length=args.frames)
    state = create_train_state(config, "cuda")
    for m in state.net.modules():
        if hasattr(m, "groups") and hasattr(m, "running_mean"):
            m.groups = args.bn_groups
    step = make_train_step(config)
    g = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.rand(args.accum, args.batch, args.frames, config.feat_dim,
                       generator=g, device="cuda")
    labels = torch.randint(0, config.num_classes, (args.accum, args.batch), generator=g,
                           device="cuda")

    step(state, feats, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step(state, feats, labels)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, feats, labels)
        torch.cuda.synchronize()
    kernels, calls = {}, {}
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.key.startswith("Command Buffer"):
            continue
        kernels[e.key] = e.device_time_total / args.steps / 1e3
        calls[e.key] = e.count // args.steps
        busy_us += e.device_time_total
    span = [ev for ev in prof.events()
            if ev.device_type.name == "CUDA" and not ev.name.startswith("Command Buffer")]
    window_us = (max(ev.time_range.end for ev in span) - min(ev.time_range.start for ev in span)
                 if span else 0.0)
    top = {k: [v, calls[k]] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:40]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    med = statistics.median(times)
    print(json.dumps({
        "model": args.model, "batch": args.batch, "accum": args.accum, "frames": args.frames,
        "bn_groups": args.bn_groups, "dtype": "bfloat16",
        "step_ms_median": med, "step_ms_all": times,
        "audio_s_per_s": args.batch * args.accum * args.frames / 100.0 / (med / 1e3),
        "peak_memory_bytes": peak,
        "device_ms_per_step": busy_us / args.steps / 1e3,
        "device_idle_share": (1.0 - busy_us / window_us) if window_us else None,
        "device_ms_and_calls_by_kernel": top, "nvidia_smi": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
