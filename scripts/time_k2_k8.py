#!/usr/bin/env python3
"""Device time of K2's wide split chain and of K8's forward on a GPU, at the
shapes the main paths give them; runs in this tree or, copied into an older
one's ``scripts/``, in that tree the same way (it uses only the wrappers'
public functions and ``chip_smoke.py``'s timing helpers).

    python3 scripts/time_k2_k8.py [--label NAME] [--batch 128]

K2: one stride-1 split chain (split 4) at res2net50_w24_s4_c32's stage-3
and stage-4 grids at B x 1000 frames, (w, T, F) = (96, 250, 20) and (192,
125, 10), and res2net50_w8_s6_c16's stage 4 (64, 125, 10) at split 6, in
bf16 with a mask: the split kernels' device time by torch.profiler over 20
calls, the call's (with the wrapper's weight layout copy), cuDNN's conv
alone (``F.conv2d`` per group, eval BN folded into weight and bias, no
masked add, no relu) as chip_smoke.py times it, the plan, and the bound
(2 (s-1) M 9 w^2 operations at 989 TFLOP/s; x read and the output written
once). K8: ``att_pool``'s forward kernel at res2net200_att's serving head
(B x 1024, 125 frames, W 10, masked) and training head (128, 1024, 25, 10)
and ECAPA-512's (256, 1536, 200, 1), bf16, and its bound (x and s read
once, the pooled rows written). One JSON line, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch import kernels  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops  # noqa: E402

K2_SHAPES = ((96, 250, 20, 4), (192, 125, 10, 4), (64, 125, 10, 6))


def k2_row(dev, gen, batch, w, t, f, split):
    mask = cs.lengths_mask(gen, batch, t, dev)
    x = torch.randn((batch, split * w, t, f), generator=gen, device=dev)
    x = (x * mask[:, None, :, None]).bfloat16().contiguous(memory_format=torch.channels_last)
    weight = (torch.randn((w * (split - 1), w, 3, 3), generator=gen, device=dev)
              / math.sqrt(9 * w)).bfloat16()
    means = [0.1 * torch.randn(w, generator=gen, device=dev) for _ in range(split - 1)]
    var = [0.5 + 1.5 * torch.rand(w, generator=gen, device=dev) for _ in range(split - 1)]
    call = lambda: rn.split_chain(x, weight, means, var, mask)  # noqa: E731
    got = call().float()
    want = rn.split_chain_reference(x.float(), weight.float(), means, var, mask)
    xg = x[:, :w].contiguous(memory_format=torch.channels_last)
    lib = 0.0
    for i in range(split - 1):
        rstd = torch.rsqrt(var[i] + 1e-5)
        wf = (weight[i * w: (i + 1) * w].float() * rstd[:, None, None, None]).bfloat16().contiguous(
            memory_format=torch.channels_last)
        bias = (-means[i] * rstd).bfloat16()
        lib += cs.device_ms(lambda: F.conv2d(xg, wf, bias, padding=1))
    flops = (split - 1) * 2 * batch * t * f * 9 * w * w
    nbytes = 2 * (2 * batch * t * f * split * w) + 2 * weight.numel() + 4 * batch * t
    bms, by = cs.bound_ms(nbytes, flops, torch.bfloat16)
    return {"width": w, "T": t, "F": f, "split": split,
            "plan": rn.split_plan(w, t, f, torch.bfloat16, split),
            "rel_err_vs_plain": float((got - want).abs().max() / want.abs().max()),
            "device_ms": cs.device_ms(call, "split_"), "device_ms_call": cs.device_ms(call),
            "cudnn_conv_only_device_ms": lib, "bound_ms": bms, "bound_by": by}


def k8_row(dev, gen, shape, masked):
    x, s, mask = cs.att_inputs(gen, shape, masked, torch.bfloat16, dev)
    nel = x.numel()
    b, c, _, w = shape
    bms, by = cs.bound_ms(2 * (2 * nel + b * 2 * c * w), 12.0 * nel, torch.float32)
    return {"shape": list(shape), "masked": masked,
            "device_ms": cs.device_ms(lambda: ops.att_pool(x, s, mask), "att_pool_fwd_kernel"),
            "bound_ms": bms, "bound_by": by}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--label", default="tree")
    p.add_argument("--batch", type=int, default=128)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k2_k8: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all([kernels.SPLIT_CONV, kernels.ATT_POOL])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    with torch.inference_mode():
        k2 = [k2_row(dev, gen, args.batch, *shape) for shape in K2_SHAPES]
        k8 = {name: k8_row(dev, gen, shape, masked) for name, (shape, masked)
              in cs.ATT_SHAPES.items() if name != "ragged_c20_t1"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "k2": k2, "k8_forward": k8, "nvidia_smi": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
