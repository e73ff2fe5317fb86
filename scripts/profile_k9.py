#!/usr/bin/env python3
"""Where K9 / K9b (the stride-1 split chain in training) spend their time,
by role and phase, on a GPU.

    python3 scripts/profile_k9.py [--shapes all|bench|w24] [--save OUT.json]
        [--tree DIR]

Builds csrc/split_train.cu once more with -DVSV_K9_PROF (into the kernels'
build directory), so that one thread of each CTA role laps clock64 into the
role's phases and adds them to a device array at its end, and runs one
forward + backward of the chain through ``Res2NetSplitConv`` in training
(bf16, bn_groups 8) at each shape of ``scripts/time_split_train.py``'s
``--shapes`` (``all``: the bench step's four stride-1 stages and
res2net200_att's four). Roles: the forward (``fwd``), the statistics launch
(``stats``), the input gradient (``dgrad``) and the weight gradient
(``wgrad``). Phases: ``stage`` (the patch's operand staged, or waited for,
with its barriers), ``mma`` (the tensor-core or FMA loop, with its operand
loads and weight waits), ``epilogue`` (rounding, stores, the per-patch
sums), ``sums`` (the slab partials and the last CTA's ticket and
collapse), ``reduce`` (the weight gradient's split sums), ``weights`` (the
weights staged before the first patch; the Hopper design: the weight
thread's waits for a free ring slot), and the Hopper design's producer
warps: ``produce`` (staging) and ``produce_wait`` (waiting for a free
stage). Prints one JSON line a shape: the
chain's fwd + bwd ms with the counters on (CUDA events), the launches by C
function, and per role its CTAs, patches and, per phase, the microseconds
summed over its CTAs divided by the card's SM count (``*_us_per_sm``: the
share of the chain's wall time if the CTAs spread evenly and ran one at a
time an SM) and a CTA's mean (``*_us_per_cta``), at the card's maximum SM
clock as nvidia-smi reports it; then the card's name and power limit.

``--tree DIR`` profiles the port of another checkout (imported from DIR,
its csrc/split_train.cu built) whose split_train.cu has the profile build.
The first design's profile (commit 524056f) comes from that commit's
source with the same hooks, which scripts/profile_k9_parent.patch adds:

    mkdir -p _scratch/parent && git archive 524056f | tar -x -C _scratch/parent
    patch -d _scratch/parent -p1 < scripts/profile_k9_parent.patch
    python3 scripts/profile_k9.py --tree _scratch/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from time_split_train import GROUPS, SHAPES, events_ms  # noqa: E402

ROLES = ("fwd", "stats", "dgrad", "wgrad")
PHASES = ("stage", "mma", "epilogue", "sums", "reduce", "weights", "produce", "produce_wait")
SLOTS = PHASES + ("patches", "ctas")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--shapes", choices=sorted(SHAPES), default="all")
    p.add_argument("--save", default=None)
    p.add_argument("--tree", default=None,
                   help="a checkout whose port (and its split_train.cu) to profile")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_k9: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from voxsrc2020_speaker_verification_tpu_torch import kernels, set_float32_precision
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import Res2NetSplitConv
    set_float32_precision()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(kernels.BUILD_DIR, "split_train_prof.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DVSV_K9_PROF", "-o", lib_path,
                    kernels.SPLIT_TRAIN.source_path], check=True)
    kernels.SPLIT_TRAIN.library_path = lambda: lib_path
    lib = kernels.SPLIT_TRAIN.load()
    lib.split_train_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters = np.zeros(len(ROLES) * len(SLOTS), np.uint64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1])
    dev = torch.device("cuda")
    sms = kernels.num_sms(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape, w, s in SHAPES[args.shapes]:
        mod = Res2NetSplitConv(s, w, 1).to(dev)
        with torch.no_grad():
            mod.weight.normal_(0.0, (9 * w) ** -0.5, generator=g)
        for i in range(s - 1):
            getattr(mod, f"bn{i}").groups = GROUPS
        x = torch.randn(shape, generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        dy = torch.randn(shape, generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last)

        def fwd_bwd():
            torch.autograd.grad(mod(x, True), [x, mod.weight], dy)

        ms = events_ms(fwd_bwd, 3)
        torch.cuda.synchronize()
        lib.split_train_prof(counters.ctypes.data, 1)  # read and clear
        before = kernels.function_launch_counts()
        fwd_bwd()
        torch.cuda.synchronize()
        after = kernels.function_launch_counts()
        code = lib.split_train_prof(counters.ctypes.data, 1)
        if code:
            raise RuntimeError(f"split_train_prof: CUDA error {code}")
        c = counters.reshape(len(ROLES), len(SLOTS)).astype(np.float64)
        row = {"shape": list(shape), "width": w, "split": s, "fwd_bwd_ms_instrumented": ms,
               "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
        for r, role in enumerate(ROLES):
            ctas = c[r, SLOTS.index("ctas")]
            if not ctas:
                continue
            d = {"ctas": int(ctas), "patches": int(c[r, SLOTS.index("patches")])}
            for i, ph in enumerate(PHASES):
                d[f"{ph}_us_per_sm"] = c[r, i] / sms / mhz
                d[f"{ph}_us_per_cta"] = c[r, i] / ctas / mhz
            row[role] = d
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, dy, mod
        torch.cuda.empty_cache()
    print(json.dumps({"nvidia_smi": smi, "sms": sms}), flush=True)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "w") as f:
            json.dump({"nvidia_smi": smi, "sms": sms, "shapes": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
