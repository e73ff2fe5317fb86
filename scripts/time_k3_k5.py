#!/usr/bin/env python3
"""Device time of K3 (eval BN, ``ops.nn.bn_act``) and K5 (training BN,
``ops.nn.bn_train``) at dpn68's 10-channel calls, and of K5's 2-D head
calls, with the bytes bound and one PyTorch call that computes the same
normalization beside each, on one GPU.

    python3 scripts/time_k3_k5.py [--reps 20] [--rounds 2] [--label L]
                                  [--save OUT.pt] [--compare-with OTHER.pt]

Shapes (B, C, T, F), bf16 and float32, bn_groups 8: dpn68's stem (256, 10,
200, 80) (its initial BN and stage 1's first projection and conv_a BNs),
the f600 finetune shape (256, 10, 600, 80), the voxsrc2020 shape (1024, 10,
320, 40), and for K3 the extraction bucket (128, 10, 1000, 80). K5: the
forward (under no_grad) and the backward (``torch.autograd.grad``) apart,
under relu; its yardstick ``F.batch_norm`` in training mode at one group,
forward and backward. K3: relu and a time mask (lengths from a seed); its
yardstick ``F.batch_norm`` in eval mode. K5's 2-D head calls (no relu),
bf16 and float32, at their recipes' rows and bn_groups (HEAD_SHAPES): the
bench step's pre_bn and post_bn (256, 10240) and (256, 192) in 8 groups,
--single-chip's (512, 10240) in 16, res2net50_w24_s4_c32's and
res2net50_w24_s4_c64's, res2net200_att's --single-chip (128, 20480) in 4,
dpn68's, TDNN's at 1024 rows and ECAPA-512's (its recipe's one group, and
8), each with the plain version's time (``bn_train_reference`` and its
autograd) beside the kernel's and the library's. Device
milliseconds come from torch.profiler (CUPTI) over ``--reps`` calls after a
warm-up, every device kernel of the call, each measured ``--rounds`` times
in turns; beside each, the CUDA kernels a call launches and the design it
took (``bn_train_plan``; ``bn_act_plan`` where the tree has it, else K3's
earlier rule: 4-channel vectors where C % 4 == 0, single channels
otherwise). Bounds: bytes, each input read once and each output written
once at 3.35 TB/s: K5's forward x and y, its backward x, dy and dx; K3's x,
y and the float32 mask. The script uses only the wrappers' public
interfaces, so the same file times an older tree of the port when copied
into it. ``--save`` writes the outputs at the first batch row (K3's y, K5's
y, dx and running statistics) to a file; ``--compare-with`` reads such a
file from another tree on the same card and reports the largest absolute
difference of each. Prints one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops  # noqa: E402

K5_SHAPES = {"stem": (256, 10, 200, 80), "f600": (256, 10, 600, 80),
             "voxsrc2020": (1024, 10, 320, 40)}
K3_SHAPES = dict(K5_SHAPES, bucket1000=(128, 10, 1000, 80))
# name -> ((B, C), bn_groups); (256, 256) in 8 groups is the post_bn of
# res2net50_w24_s4_c32, res2net50_w24_s4_c64 and dpn68 alike
HEAD_SHAPES = {"head_pre_bn": ((256, 10240), 8), "head_post_bn": ((256, 192), 8),
               "single_chip_pre_bn": ((512, 10240), 16),
               "single_chip_post_bn": ((512, 192), 16),
               "w24_c32_pre_bn": ((256, 20480), 8), "w24_post_bn": ((256, 256), 8),
               "w24_c64_pre_bn": ((256, 40960), 8),
               "att200_single_chip_pre_bn": ((128, 20480), 4),
               "dpn68_pre_bn": ((256, 16640), 8),
               "tdnn_pre_bn": ((1024, 3072), 8), "tdnn_post_bn": ((1024, 256), 8),
               "ecapa_pre_bn": ((256, 3072), 1), "ecapa_post_bn": ((256, 192), 1),
               "ecapa_pre_bn_g8": ((256, 3072), 8), "ecapa_post_bn_g8": ((256, 192), 8)}
GROUPS = 8
HBM_BYTES_PER_S = 3.35e12


def profiled(fn, reps, tries=3):
    """(device ms of one call, CUDA kernels a call) over ``reps`` calls of
    ``fn`` after a warm-up, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and not e.key.startswith("Command Buffer")]
        us = sum(e.device_time_total for e in events)
        if us > 0:
            return us / reps / 1e3, sum(e.count for e in events) / reps
    raise RuntimeError("the profiler saw no device time")


def bound(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def k3_design(shape, dtype):
    plan = getattr(ops, "bn_act_plan", None)
    if plan is not None:
        return dict(plan(tuple(shape), dtype))
    return {"design": "vec" if shape[1] % 4 == 0 else "single"}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--save", default=None, help="write the outputs here (torch.save)")
    p.add_argument("--compare-with", default=None, help="outputs saved by another tree")
    p.add_argument("--label", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k3_k5: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    calls, bounds, designs, outputs = {}, {}, {}, {}

    def layout(t):
        return t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t

    def k5_case(name, shape, dtype, relu, groups=GROUPS, plain=False):
        x = layout((torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).to(dtype))
        dy = layout(torch.randn(shape, generator=g, device=dev).to(dtype))
        c = shape[1]
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        xi = x.detach().requires_grad_(True)
        y = ops.bn_train(xi, rm, rv, groups=groups, relu=relu)
        nbytes = x.numel() * x.element_size()

        def fwd():
            with torch.no_grad():
                return ops.bn_train(x, rm, rv, groups=groups, relu=relu)

        calls[f"k5_fwd/{name}"] = fwd
        calls[f"k5_bwd/{name}"] = lambda: torch.autograd.grad(y, [xi], dy, retain_graph=True)
        bounds[f"k5_fwd/{name}"], bounds[f"k5_bwd/{name}"] = bound(2 * nbytes), bound(3 * nbytes)
        plan = ops.bn_train_plan(tuple(shape), groups, dtype, 0, relu)
        designs[f"k5/{name}"] = {k: plan[k] for k in ("design", "fold", "lanes", "cl", "rl",
                                                      "slab", "ctas") if k in plan}
        if plain:  # the plain version, forward and its autograd
            pm, pv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
            py = ops.bn_train_reference(xi, pm, pv, groups=groups, relu=relu)

            def plain_fwd():
                with torch.no_grad():
                    return ops.bn_train_reference(x, pm, pv, groups=groups, relu=relu)

            calls[f"plain_fwd/{name}"] = plain_fwd
            calls[f"plain_bwd/{name}"] = lambda: torch.autograd.grad(py, [xi], dy,
                                                                     retain_graph=True)
        # the library yardstick: F.batch_norm in training mode, one group
        lm, lv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        li = x.detach().requires_grad_(True)
        ly = F.batch_norm(li, lm, lv, training=True, momentum=1 - ops.BN_MOMENTUM,
                          eps=ops.BN_EPSILON)
        calls[f"lib_fwd/{name}"] = lambda: F.batch_norm(
            x, lm, lv, training=True, momentum=1 - ops.BN_MOMENTUM, eps=ops.BN_EPSILON)
        calls[f"lib_bwd/{name}"] = lambda: torch.autograd.grad(ly, [li], dy, retain_graph=True)
        dx = calls[f"k5_bwd/{name}"]()[0]
        rm2, rv2 = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        with torch.no_grad():
            ops.bn_train(x, rm2, rv2, groups=groups, relu=relu)
        outputs[f"k5/{name}"] = [y[:1].detach().float().cpu(), dx[:1].float().cpu(),
                                 rm2.cpu(), rv2.cpu()]

    def k3_case(name, shape, dtype):
        x = layout((torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).to(dtype))
        c, b, t = shape[1], shape[0], shape[2]
        m, v = 0.1 * torch.randn(c, generator=g, device=dev), 0.5 + torch.rand(c, generator=g, device=dev)
        lens = torch.randint(t // 4, t + 1, (b,), generator=g, device=dev)
        mask = (torch.arange(t, device=dev)[None] < lens[:, None]).float()
        calls[f"k3/{name}"] = lambda: ops.bn_act(x, m, v, relu=True, mask=mask)
        calls[f"lib_eval/{name}"] = lambda: F.batch_norm(x, m, v, eps=ops.BN_EPSILON)
        bounds[f"k3/{name}"] = bound(2 * x.numel() * x.element_size() + 4 * b * t)
        designs[f"k3/{name}"] = k3_design(shape, dtype)
        outputs[f"k3/{name}"] = [ops.bn_act(x, m, v, relu=True, mask=mask)[:1].float().cpu()]

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for name, shape in K5_SHAPES.items():
            k5_case(f"{name}/{dn}", shape, dtype, True)
        for name, shape in K3_SHAPES.items():
            k3_case(f"{name}/{dn}", shape, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for name, (shape, groups) in HEAD_SHAPES.items():
            k5_case(f"{name}/{dn}", shape, dtype, False, groups, plain=True)

    rows = {k: [] for k in calls}
    kernels_a_call = {}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            ms, n = profiled(fn, args.reps)
            rows[name].append(ms)
            kernels_a_call[name] = n
    if args.save:
        torch.save(outputs, args.save)
    diff = None
    if args.compare_with:
        other = torch.load(args.compare_with)
        diff = {k: [float((a - b).abs().max()) for a, b in zip(v, other[k])]
                for k, v in outputs.items() if k in other}
    print(json.dumps({"label": args.label, "card": smi, "torch": torch.__version__,
                      "reps": args.reps, "rounds": args.rounds, "groups": GROUPS,
                      "head_shapes": HEAD_SHAPES,
                      "device_ms": rows, "median": {k: float(np.median(v)) for k, v in rows.items()},
                      "kernels_a_call": kernels_a_call, "bound_ms": bounds, "design": designs,
                      "max_abs_diff_to_compared": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
