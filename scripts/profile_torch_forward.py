#!/usr/bin/env python3
"""Time and profile one serving forward of the PyTorch port on a GPU.

    python3 scripts/profile_torch_forward.py [--model res2net50_w24_s4_c32]
        [--batch 128] [--frames 1000] [--reps 10]

Builds the model with seeded random weights (``convert.init_weights``), bf16
compute, and runs the embed at a full bucket batch with a mask (a quarter of
the rows half padded). Prints one JSON line: the median forward time by CUDA
events, the card's name and power limit, and the device time per kernel
name (and calls per forward) from ``torch.profiler`` over ``--reps``
forwards, and the share of the profiled window the device was idle.
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

from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.convert import init_weights  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.speaker_net import build_speaker_net  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="res2net50_w24_s4_c32")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 2

    config = TrainConfig(model=args.model, feat_dim=80, bf16=True)
    net = build_speaker_net(config, "cuda")
    net.load_state_dict(init_weights(config, torch.Generator().manual_seed(0)))
    g = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn(args.batch, args.frames, 80, generator=g, device="cuda") * 3
    mask = torch.ones(args.batch, args.frames, device="cuda")
    mask[: args.batch // 4, args.frames // 2:] = 0.0
    feats = feats * mask[..., None]

    def forward():
        with torch.inference_mode():
            return net.embed(feats, mask)

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        forward()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            forward()
        torch.cuda.synchronize()
    # device activities only (kernels, copies, fills); "Command Buffer Full"
    # is a launch-queue stall the tracer records, not device work
    kernels, calls = {}, {}
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.key.startswith("Command Buffer"):
            continue
        kernels[e.key] = e.device_time_total / args.reps / 1e3
        calls[e.key] = e.count // args.reps
        busy_us += e.device_time_total
    span = [ev for ev in prof.events()
            if ev.device_type.name == "CUDA" and not ev.name.startswith("Command Buffer")]
    window_us = (max(ev.time_range.end for ev in span) - min(ev.time_range.start for ev in span)
                 if span else 0.0)
    top = {k: [v, calls[k]] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:30]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "model": args.model, "batch": args.batch, "frames": args.frames, "dtype": "bfloat16",
        "forward_ms_median": statistics.median(times), "forward_ms_all": times,
        "audio_s_per_s": args.batch * args.frames / 100.0 / (statistics.median(times) / 1e3),
        "device_ms_per_forward": busy_us / args.reps / 1e3,
        "device_idle_share": (1.0 - busy_us / window_us) if window_us else None,
        "device_ms_and_calls_by_kernel": top, "nvidia_smi": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
