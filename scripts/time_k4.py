#!/usr/bin/env python3
"""Device time of K4 (the statistics pool) and K4b (its backward) and of
their yardsticks, on one GPU.

    python3 scripts/time_k4.py [--reps 20] [--rounds 3] [--plans]
                               [--save K4.json] [--compare-with K4.json]

Shapes (bf16, channels-last): the W = 1 heads of TDNN (1024, 1536, 320, 1)
and ECAPA-512 (256, 1536, 200, 1), an extraction bucket (128, 1536, 1000, 1)
with a lengths mask, and the two ring shapes of the Res2Net heads, serving
(128, 1024, 125, 10) masked and training (256, 512, 25, 10). At each: K4's
and K4b's device time (their kernels' own names), ``torch.var_mean`` over T
and its autograd backward (every device kernel of the call), the plain
version's forward, and the bytes bound (x read once, the pooled rows
written once; K4b: x and dout read once, dx written once) at 3.35 TB/s.
Device milliseconds come from torch.profiler (CUPTI) over ``--reps`` calls
after a warm-up; each is measured ``--rounds`` times in turns (the spread
of one card). ``--plans`` (a tree with ``ops.nn.stats_pool_plan``) also
times K4 and K4b at each W = 1 shape under every column-design tile-row
width whose two slabs fit, and under the stream design. Prints one JSON
line with the card's name and power limit.

The script uses only the wrappers' public interfaces outside ``--plans``,
so the same file times an older tree of the port when copied into it.
``--save`` writes the SHA-256 of K4's output and K4b's input gradient at
each shape; ``--compare-with`` reads such a file, from another tree on the
same card, and the JSON line says at which shapes the outputs are bit-equal.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# name: ((B, C, T, W), masked)
SHAPES = {"tdnn": ((1024, 1536, 320, 1), False), "ecapa512": ((256, 1536, 200, 1), False),
          "extract1000": ((128, 1536, 1000, 1), True),
          "ring_serve": ((128, 1024, 125, 10), True), "ring_train": ((256, 512, 25, 10), False)}


def device_ms(fn, name, reps, tries=3):
    """Device ms of one call: kernels whose name holds ``name`` (all if None).
    A window in which the profiler saw no device time is measured again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA" and not e.key.startswith("Command Buffer")
                 and (name is None or name in e.key))
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError(f"the profiler saw no device time for {name or 'the call'}")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest()


def plan_launchers(x, mask, dout):
    """{label: (forward, backward)} launching K4 / K4b at x's shape under
    each candidate plan the C entries accept at this T: the column design at
    every tile-row width whose slabs fit, and the stream design."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels

    b, c, t, w = x.shape
    size = x.element_size()
    plans = {}
    for rb in (128, 64, 32):
        smem = ops._pool_column_smem(t, rb, size)
        if smem <= ops._POOL_SMEM_LIMIT:
            plans[f"column{rb}"] = dict(design="column", row_bytes=rb,
                                        rows=math.prod(ops._pool_boxes(t)),
                                        stages=ops._POOL_COLUMN_STAGES, smem=smem)
    plans["stream"] = dict(design="stream", row_bytes=128, rows=256, stages=2,
                           smem=ops._pool_smem(2, 256, 128, size))
    out = torch.empty((b, 2 * c, 1, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    dx = torch.empty_like(x)
    m = None if mask is None else mask.float().contiguous()
    found = {}
    for label, p in plans.items():
        ints = ops.pool_plan_ints(p)

        def fwd(ints=ints, p=p):
            kernels.STATS_POOL.launch("stats_pool", x.device, kernels.dtype_code(x.dtype),
                                      x.data_ptr(), kernels.ptr(m), out.data_ptr(), b, t, w, c,
                                      ops.POOL_EPSILON, ctypes.addressof(ints), path=p["design"])

        def bwd(ints=ints, p=p):
            kernels.STATS_POOL_BWD.launch(
                "stats_pool_bwd", x.device, kernels.dtype_code(x.dtype), x.data_ptr(),
                kernels.ptr(m), dout.data_ptr(), dx.data_ptr(), b, t, w, c, ops.POOL_EPSILON,
                ctypes.addressof(ints), path=p["design"])

        found[label] = (fwd, bwd, out, dx)
    return found


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--plans", action="store_true", help="time every candidate plan too")
    p.add_argument("--save", default=None, help="write the outputs' digests here (JSON)")
    p.add_argument("--compare-with", default=None, help="digests from another tree")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k4: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    rows, digests, bounds, plans = {}, {}, {}, {}
    for name, (shape, masked) in SHAPES.items():
        b, c, t, w = shape
        g = torch.Generator(device=dev).manual_seed(17)
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 1).bfloat16().contiguous(
            memory_format=torch.channels_last)
        dout = torch.randn((b, 2 * c, 1, w), generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last)
        mask = None
        if masked:
            lens = torch.randint(max(1, t // 4), t + 1, (b,), generator=g, device=dev)
            mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
        xi = x.detach().requires_grad_(True)
        y = ops.stats_pool(xi, mask)
        dx = torch.autograd.grad(y, [xi], dout, retain_graph=True)[0]
        digests[name] = {"k4": digest(y), "k4b": digest(dx)}
        del dx
        vx = x.detach().requires_grad_(True)
        vv, vm = torch.var_mean(vx, dim=2, keepdim=True, correction=0)
        dv, dm = torch.randn_like(vv), torch.randn_like(vm)
        mbytes = 0 if mask is None else 4 * b * t
        bounds[name] = {
            "k4": 1e3 * (2 * x.numel() + mbytes + 2 * b * 2 * c * w) / HBM_BYTES_PER_S,
            "k4b": 1e3 * (2 * 2 * x.numel() + mbytes + 2 * dout.numel()) / HBM_BYTES_PER_S}
        calls = {
            "k4": (lambda: ops.stats_pool(x, mask), "stats_pool_kernel"),
            "k4b": (lambda: torch.autograd.grad(y, [xi], dout, retain_graph=True),
                    "stats_pool_bwd_kernel"),
            "var_mean": (lambda: torch.var_mean(x, dim=2, keepdim=True, correction=0), None),
            "var_mean_autograd": (lambda: torch.autograd.grad((vv, vm), [vx], (dv, dm),
                                                              retain_graph=True), None),
            "plain_k4": (lambda: ops.stats_pool_reference(x, mask), None)}
        cand = plan_launchers(x, mask, dout) if args.plans and hasattr(ops, "stats_pool_plan") \
            and t > 128 else {}
        for label, (f, bk, _, _) in cand.items():
            calls[f"k4_{label}"] = (f, "stats_pool_kernel")
            calls[f"k4b_{label}"] = (bk, "stats_pool_bwd_kernel")
        res = {k: [] for k in calls}
        for _ in range(args.rounds):
            for k, (fn, kname) in calls.items():
                res[k].append(device_ms(fn, kname, args.reps))
        rows[name] = {k: {"device_ms": v, "median": float(np.median(v))} for k, v in res.items()}
        if hasattr(ops, "stats_pool_plan"):
            plans[name] = ops.stats_pool_plan(b, t, w, c, torch.bfloat16)
        del x, xi, y, dout, vx, vv, vm, dv, dm, cand, calls
        torch.cuda.empty_cache()
    if args.save:
        with open(args.save, "w") as f:
            json.dump(digests, f)
    same = None
    if args.compare_with:
        with open(args.compare_with) as f:
            other = json.load(f)
        same = {k: {o: v[o] == other.get(k, {}).get(o) for o in v} for k, v in digests.items()}
    print(json.dumps({"card": smi, "torch": torch.__version__, "reps": args.reps,
                      "rounds": args.rounds, "bound_ms": bounds, "rows": rows, "plans": plans,
                      "bit_equal_to_compared": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
