#!/usr/bin/env python3
"""Device time of K10 (the stride-2 split stage in eval) on a GPU.

    python3 scripts/time_k10.py [--models res2net50_w24_s4_c32 res2net50_w8_s6_c16]
        [--batch 128] [--frames 1000] [--plans] [--reps 20]

For every stride-2 stage of a B x FRAMES forward of each model (bf16,
seeded inputs with a quarter of the rows half padded), prints one JSON line:
the shape, the bytes bound at 3.35 TB/s, the plan ``stride2_plan`` picks and
K10's device ms there by torch.profiler (the kernel alone, over ``--reps``
calls); with ``--plans`` every mma plan of ``stride2_candidates`` too, each
output's largest difference from the picked plan's relative to its largest
magnitude (0 where both take one K order: the same channel passes). The
last line sums the picked plans' device ms a forward of each model, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def stride2_shapes(model: str, batch: int, frames: int, feat_dim: int = 80):
    """(width, split, input shape) of each stride-2 stage of the forward."""
    cfg = RES2NET_CONFIGS[model]
    t, f, out = frames, feat_dim, []
    for i in range(len(cfg.block_sizes)):
        w, s = cfg.width[i], cfg.block_strides[i]
        if s == 2:
            out.append((w, cfg.split, (batch, cfg.split * w, t, f)))
            t, f = rn._strided(t, 2), rn._strided(f, 2)
    return out


def device_ms(fn, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "stride2" in e.key) / reps / 1e3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+", default=["res2net50_w24_s4_c32", "res2net50_w8_s6_c16"])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--plans", action="store_true")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k10: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    totals = {}
    for model in args.models:
        totals[model] = 0.0
        for w, s, shape in stride2_shapes(model, args.batch, args.frames):
            b, c, t, f = shape
            x = torch.randn(shape, generator=g, device=dev)
            x[: b // 4, :, t // 2:] = 0.0
            x = x.bfloat16().contiguous(memory_format=torch.channels_last)
            weight = (torch.randn((s - 1) * w, w, 3, 3, generator=g, device=dev)
                      / (9 * w) ** 0.5).bfloat16()
            means = [torch.randn(w, generator=g, device=dev) * 0.1 for _ in range(s - 1)]
            var = [torch.rand(w, generator=g, device=dev) + 0.5 for _ in range(s - 1)]
            plan = rn.stride2_plan(w, s, shape, torch.bfloat16)
            want = rn.split_stride2(x, weight, means, var)
            ms = device_ms(lambda: rn.split_stride2(x, weight, means, var), args.reps)
            t2, f2 = rn._strided(t, 2), rn._strided(f, 2)
            line = {"model": model, "width": w, "split": s, "input": list(shape),
                    "bound_ms": 2 * b * c * (t * f + t2 * f2) / HBM_BYTES_PER_S * 1e3,
                    "plan": plan, "device_ms": ms}
            totals[model] += ms
            if args.plans:
                line["candidates"] = []
                for cand in rn.stride2_candidates(w, s, shape):
                    out = torch.empty_like(want)
                    rn._stride2_launch(x, weight, means, var, 1e-5, cand, out)
                    line["candidates"].append({
                        **{k: cand[k] for k in ("nt", "wn", "wm", "tt", "tf", "passes",
                                                "wstages", "ksl", "smem")},
                        "device_ms": device_ms(
                            lambda: rn._stride2_launch(x, weight, means, var, 1e-5, cand, out),
                            args.reps),
                        "rel_diff": float((out.float() - want.float()).abs().max()
                                          / want.float().abs().max())})
            print(json.dumps(line), flush=True)
            del x, want
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device_ms_per_forward": totals, "batch": args.batch,
                      "frames": args.frames, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
