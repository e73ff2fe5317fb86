#!/usr/bin/env python3
"""Device time of K11 / K11b (the stride-2 split stage in training) on a GPU.

    python3 scripts/time_k11.py [--tree DIR] [--label L] [--route]
        [--reps 20] [--save OUT.json]

At each stride-2 shape of ``SHAPES`` (the bench step's three, B = 256 at
w = 16 / 32 / 64, and res2net200_att's three, B = 128 at w = 48 / 96 /
192; bf16, bn_groups 8, seeded inputs) prints one JSON line: K11's device
ms (its own kernels, ``K11_KERNELS``: the conv launch and the finishing
launch) and the stage's (every device kernel of the call), K11b's and the
stage's backward likewise (the gradients of x and of the weight), the
bytes bound of each direction at 3.35 TB/s (as ``chip_smoke.py``'s rows
count it) and each time's share of it; with ``--route`` also the route
K11 / K11b replaced (``_split_stride2_span`` without a mesh, through
autograd). The last line sums each time over the bench step (three
stages a microbatch, four microbatches) beside the card's name and power
limit. Device ms by torch.profiler over ``--reps`` calls after a warm-up,
also by device kernel (``by_kernel_*``).

``--tree DIR`` times the port of another checkout (imported from DIR, its
kernels built from its own sources): with an unpacked parent commit, parent
and this tree in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12
GROUPS = 8
BENCH_ACCUM = 4
# (x shape (B, s w, T, F), w, s, stages a bench microbatch)
SHAPES = (((256, 96, 200, 80), 16, 6, 1), ((256, 192, 100, 40), 32, 6, 1),
          ((256, 384, 50, 20), 64, 6, 1), ((128, 192, 200, 80), 48, 4, 0),
          ((128, 384, 100, 40), 96, 4, 0), ((128, 768, 50, 20), 192, 4, 0))
# K11's and K11b's device kernels (csrc/split_stride2_train.cu)
K11_KERNELS = ("fwd_mma_kernel", "fwd_fma_kernel", "finish_kernel")
K11B_KERNELS = ("bwd_stats_kernel", "grad_mma_kernel", "grad_fma_kernel")


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


def device_ms(kernels: dict, names=None) -> float:
    """The device ms of ``kernels`` (by_kernel's) whose name holds one of
    ``names`` (every one if None)."""
    return sum(v for k, v in kernels.items() if names is None or any(n in k for n in names))


def stage_inputs(shape, w, s, dev, seed=0):
    """x, weight, the output's cotangent and running statistics (bf16)."""
    b, c, t, f = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.2).bfloat16().contiguous(
        memory_format=cl)
    weight = (torch.randn(((s - 1) * w, w, 3, 3), generator=g, device=dev)
              / (9 * w) ** 0.5).bfloat16()
    dout = torch.randn((b, c, (t - 1) // 2 + 1, (f - 1) // 2 + 1), generator=g,
                       device=dev).bfloat16().contiguous(memory_format=cl)
    rm = [0.1 * torch.randn(w, generator=g, device=dev) for _ in range(s - 1)]
    rv = [0.5 + torch.rand(w, generator=g, device=dev) for _ in range(s - 1)]
    return x, weight, dout, rm, rv


def bounds_ms(shape, w, s):
    """(forward, backward) bytes bound in ms: forward x read, z and the tail
    written, z read and the groups written; backward dout's groups and z
    read (the sums), dout, z and x read and dx written; the weights each
    way."""
    b, c, t, f = shape
    tout, fout = (t - 1) // 2 + 1, (f - 1) // 2 + 1
    x_bytes, out_bytes = 2 * b * c * t * f, 2 * b * c * tout * fout
    z_bytes, w_bytes = 2 * b * (s - 1) * w * tout * fout, 2 * (s - 1) * w * w * 9
    return ((x_bytes + out_bytes + 2 * z_bytes + 2 * w_bytes) / HBM_BYTES_PER_S * 1e3,
            (3 * z_bytes + out_bytes + 2 * x_bytes + 4 * w_bytes) / HBM_BYTES_PER_S * 1e3)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tree", default=None, help="a checkout whose port to time")
    p.add_argument("--label", default=None)
    p.add_argument("--route", action="store_true", help="time the replaced route too")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--save", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k11: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from voxsrc2020_speaker_verification_tpu_torch import set_float32_precision
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    set_float32_precision()
    dev = torch.device("cuda")
    label = args.label or (args.tree or "this tree")
    rows, step = [], {}
    for shape, w, s, per_mb in SHAPES:
        x, weight, dout, rm, rv = stage_inputs(shape, w, s, dev)

        def fwd():
            return rn.split_stride2_train(x, weight, rm, rv, GROUPS)

        with torch.no_grad():
            kf = by_kernel(fwd, args.reps)
        k11, sfwd = device_ms(kf, K11_KERNELS), device_ms(kf)
        xl, wl = x.detach().requires_grad_(True), weight.detach().requires_grad_(True)
        y = rn.split_stride2_train(xl, wl, rm, rv, GROUPS)

        def bwd():
            return torch.autograd.grad(y, [xl, wl], dout, retain_graph=True)

        kb = by_kernel(bwd, args.reps)
        k11b, sbwd = device_ms(kb, K11B_KERNELS), device_ms(kb)
        del y
        bf, bb = bounds_ms(shape, w, s)
        row = {"label": label, "shape": list(shape), "width": w, "split": s,
               "device_ms_fwd": k11, "stage_device_ms_fwd": sfwd,
               "device_ms_bwd": k11b, "stage_device_ms_bwd": sbwd,
               "bound_ms_fwd": bf, "bound_ms_bwd": bb,
               "bound_share_fwd": bf / k11, "bound_share_bwd": bb / k11b,
               "by_kernel_fwd": kf, "by_kernel_bwd": kb}
        if args.route:
            with torch.no_grad():
                row["route_device_ms_fwd"] = device_ms(by_kernel(
                    lambda: rn._split_stride2_span(x, weight, rm, rv, GROUPS), args.reps))
            y = rn._split_stride2_span(xl, wl, rm, rv, GROUPS)
            row["route_device_ms_bwd"] = device_ms(by_kernel(bwd, args.reps))
            del y
        if hasattr(rn, "stride2_train_plan"):
            plan = rn.stride2_train_plan(w, s, shape, GROUPS, torch.bfloat16)
            row["plan"] = {k: v for k, v in plan.items() if isinstance(v, (int, str))}
        rows.append(row)
        print(json.dumps(row), flush=True)
        for k in ("device_ms_fwd", "device_ms_bwd", "stage_device_ms_fwd", "stage_device_ms_bwd",
                  "bound_ms_fwd", "bound_ms_bwd"):
            step[k] = step.get(k, 0.0) + BENCH_ACCUM * per_mb * row[k]
        del x, xl, wl, dout
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    total = {"label": label, "bench_step": step,
             "bench_step_k11_plus_k11b_ms": step["device_ms_fwd"] + step["device_ms_bwd"],
             "nvidia_smi": smi}
    print(json.dumps(total), flush=True)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "w") as f:
            json.dump({"shapes": rows, **total}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
