#!/usr/bin/env python3
"""Device time of K10 (the stride-2 split stage in eval) on a GPU.

    python3 scripts/time_k10.py [--tree DIR] [--label L] [--save OUT.json]
        [--models res2net50_w24_s4_c32 res2net50_w8_s6_c16]
        [--batch 128] [--frames 1000] [--plans] [--reps 20]

For every stride-2 stage of a B x FRAMES forward of each model (bf16,
seeded inputs with a quarter of the rows half padded), prints one JSON line:
the shape, the bytes bound at 3.35 TB/s (x read once, the output written
once), the plan ``stride2_plan`` picks, K10's device ms there by
torch.profiler over ``--reps`` calls (``device_ms``: the kernel alone;
``device_ms_call``: every device kernel of the call, so a weight copy
before the launch shows) and its share of the bound; with ``--plans``
every mma plan of ``stride2_candidates`` too, each output's largest
difference from the picked plan's relative to its largest magnitude. The
last line sums the picked plans' device ms a forward of each model, with
the card's name and power limit.

``--tree DIR`` times the port of another checkout (imported from DIR, its
kernels built from its own sources): with an unpacked parent commit,
parent and this tree in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12
MODELS = ("res2net50_w24_s4_c32", "res2net50_w8_s6_c16")


def stride2_shapes(configs, strided, model: str, batch: int, frames: int, feat_dim: int = 80):
    """(width, split, input shape) of each stride-2 stage of the forward."""
    cfg = configs[model]
    t, f, out = frames, feat_dim, []
    for i in range(len(cfg.block_sizes)):
        w, s = cfg.width[i], cfg.block_strides[i]
        if s == 2:
            out.append((w, cfg.split, (batch, cfg.split * w, t, f)))
            t, f = strided(t, 2), strided(f, 2)
    return out


def stage_inputs(w: int, s: int, shape, g: torch.Generator, dev: torch.device):
    """x (bf16, channels_last, a quarter of the rows zero past half their
    frames), the OIHW weight (bf16) and the s-1 groups' running means and
    variances, from ``g``."""
    b, _, t, _ = shape
    x = torch.randn(shape, generator=g, device=dev)
    x[: b // 4, :, t // 2:] = 0.0
    x = x.bfloat16().contiguous(memory_format=torch.channels_last)
    weight = (torch.randn((s - 1) * w, w, 3, 3, generator=g, device=dev)
              / (9 * w) ** 0.5).bfloat16()
    means = [torch.randn(w, generator=g, device=dev) * 0.1 for _ in range(s - 1)]
    var = [torch.rand(w, generator=g, device=dev) + 0.5 for _ in range(s - 1)]
    return x, weight, means, var


def bound_ms(shape) -> float:
    """x read once and the output written once, bf16, at 3.35 TB/s."""
    b, c, t, f = shape
    t2, f2 = (t - 1) // 2 + 1, (f - 1) // 2 + 1
    return 2 * b * c * (t * f + t2 * f2) / HBM_BYTES_PER_S * 1e3


def by_kernel(fn, reps: int) -> dict:
    """Device ms of one call of ``fn`` by torch.profiler, by device kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.device_type.name == "CUDA" and not e.key.startswith("Command Buffer")}


def plan_ints(plan: dict) -> dict:
    return {k: v for k, v in plan.items() if isinstance(v, (int, str))}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tree", default=None, help="a checkout whose port to time")
    p.add_argument("--label", default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--models", nargs="+", default=list(MODELS))
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--plans", action="store_true")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k10: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    dev = torch.device("cuda")
    label = args.label or (args.tree or "this tree")
    g = torch.Generator(device=dev).manual_seed(0)
    totals, rows = {}, []
    for model in args.models:
        totals[model] = 0.0
        for w, s, shape in stride2_shapes(RES2NET_CONFIGS, rn._strided, model, args.batch,
                                          args.frames):
            x, weight, means, var = stage_inputs(w, s, shape, g, dev)
            plan = rn.stride2_plan(w, s, shape, torch.bfloat16)
            want = rn.split_stride2(x, weight, means, var)
            kern = by_kernel(lambda: rn.split_stride2(x, weight, means, var), args.reps)
            ms = sum(v for k, v in kern.items() if "stride2" in k)
            bms = bound_ms(shape)
            line = {"label": label, "model": model, "width": w, "split": s,
                    "input": list(shape), "bound_ms": bms, "plan": plan_ints(plan),
                    "device_ms": ms, "device_ms_call": sum(kern.values()),
                    "bound_share": bms / ms, "by_kernel": kern}
            totals[model] += ms
            if args.plans:
                line["candidates"] = []
                for cand in rn.stride2_candidates(w, s, shape):
                    out = torch.empty_like(want)
                    rn._stride2_launch(x, weight, means, var, 1e-5, cand, out)
                    cms = sum(v for k, v in by_kernel(
                        lambda: rn._stride2_launch(x, weight, means, var, 1e-5, cand, out),
                        args.reps).items() if "stride2" in k)
                    line["candidates"].append({
                        **plan_ints(cand), "device_ms": cms,
                        "rel_diff": float((out.float() - want.float()).abs().max()
                                          / want.float().abs().max())})
            rows.append(line)
            print(json.dumps(line), flush=True)
            del x, want
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    total = {"label": label, "device_ms_per_forward": totals, "batch": args.batch,
             "frames": args.frames, "nvidia_smi": smi}
    print(json.dumps(total), flush=True)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "w") as f:
            json.dump({"shapes": rows, **total}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
