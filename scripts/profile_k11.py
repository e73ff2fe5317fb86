#!/usr/bin/env python3
"""Where K11 / K11b (the stride-2 split stage in training) spend their time,
by CTA role and phase, on a GPU.

    python3 scripts/profile_k11.py [--tree DIR] [--save OUT.json]

Builds csrc/split_stride2_train.cu once more with -DVSV_K11_PROF (into the
kernels' build directory), so that thread 0 of each CTA laps clock64 into
its role's phases and adds them to a device array at its end, and runs one
forward + backward of ``split_stride2_train`` (bf16, bn_groups 8) at each
shape of ``scripts/time_k11.py``'s ``SHAPES``. Roles: the forward's conv
CTAs (``fwd``) and average-pool CTAs (``pool``), the statistics launch
(``stats``), the backward's CTAs (``grad``: each tile's dz staged once for
the input and the weight gradient; the first design's ``dgrad`` and
``wgrad`` CTAs apart) and the pool's backward (``pool_bwd``). Phases:
``stage`` (waiting for a tile's operands, with its barrier), ``mma`` (the
conv's or the weight gradient's tensor-core loop), ``dgrad`` (the input
gradient's loop), ``epilogue`` (rounding, stores, per-tile sums),
``sums`` (the partials and the ticket), ``reduce`` (the last CTA's
collapse or split sums), ``produce`` (issuing the next tile's copies, and
dz computed from the staged dout and z) and ``produce_wait``. Prints one
JSON line a shape: the stage's fwd + bwd ms with the counters on (CUDA
events), the launches by C function, and per role its CTAs, tiles and, per
phase, the microseconds summed over its CTAs divided by the card's SM
count (``*_us_per_sm``: the share of the launch's wall time if the CTAs
spread evenly and ran one at a time an SM) and a CTA's mean
(``*_us_per_cta``), at the card's maximum SM clock as nvidia-smi reports
it; then the card's name and power limit.

``--tree DIR`` profiles the port of another checkout whose
split_stride2_train.cu has the profile build. The first design's profile
(commit 2fafa0a) comes from that commit's source with the same hooks, which
scripts/profile_k11_parent.patch adds:

    mkdir -p _scratch/parent && git archive 2fafa0a | tar -x -C _scratch/parent
    patch -d _scratch/parent -p1 < scripts/profile_k11_parent.patch
    python3 scripts/profile_k11.py --tree _scratch/parent
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

from time_k11 import GROUPS, SHAPES, stage_inputs  # noqa: E402

ROLES = ("fwd", "pool", "stats", "dgrad", "wgrad", "grad", "pool_bwd")
PHASES = ("stage", "mma", "dgrad", "epilogue", "sums", "reduce", "produce", "produce_wait")
SLOTS = PHASES + ("tiles", "ctas")


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--save", default=None)
    p.add_argument("--tree", default=None,
                   help="a checkout whose port (and its split_stride2_train.cu) to profile")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_k11: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from voxsrc2020_speaker_verification_tpu_torch import kernels, set_float32_precision
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    set_float32_precision()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(kernels.BUILD_DIR, "split_stride2_train_prof.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DVSV_K11_PROF", "-o", lib_path,
                    kernels.SPLIT_STRIDE2_TRAIN.source_path], check=True)
    kernels.SPLIT_STRIDE2_TRAIN.library_path = lambda: lib_path
    lib = kernels.SPLIT_STRIDE2_TRAIN.load()
    lib.split_stride2_train_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters = np.zeros(len(ROLES) * len(SLOTS), np.uint64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1])
    dev = torch.device("cuda")
    sms = kernels.num_sms(dev)
    rows = []
    for shape, w, s, _ in SHAPES:
        x, weight, dout, rm, rv = stage_inputs(shape, w, s, dev)
        xl, wl = x.detach().requires_grad_(True), weight.detach().requires_grad_(True)

        def fwd_bwd():
            y = rn.split_stride2_train(xl, wl, rm, rv, GROUPS)
            torch.autograd.grad(y, [xl, wl], dout)

        ms = events_ms(fwd_bwd, 3)
        torch.cuda.synchronize()
        lib.split_stride2_train_prof(counters.ctypes.data, 1)  # read and clear
        before = kernels.function_launch_counts()
        fwd_bwd()
        torch.cuda.synchronize()
        after = kernels.function_launch_counts()
        code = lib.split_stride2_train_prof(counters.ctypes.data, 1)
        if code:
            raise RuntimeError(f"split_stride2_train_prof: CUDA error {code}")
        c = counters.reshape(len(ROLES), len(SLOTS)).astype(np.float64)
        row = {"shape": list(shape), "width": w, "split": s, "fwd_bwd_ms_instrumented": ms,
               "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
               "plan": {k: v for k, v in rn.stride2_train_plan(
                   w, s, shape, GROUPS, torch.bfloat16).items() if isinstance(v, (int, str))}}
        for r, role in enumerate(ROLES):
            ctas = c[r, SLOTS.index("ctas")]
            if not ctas:
                continue
            d = {"ctas": int(ctas), "tiles": int(c[r, SLOTS.index("tiles")])}
            for i, ph in enumerate(PHASES):
                if c[r, i]:
                    d[f"{ph}_us_per_sm"] = c[r, i] / sms / mhz
                    d[f"{ph}_us_per_cta"] = c[r, i] / ctas / mhz
            row[role] = d
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, xl, wl, dout
        torch.cuda.empty_cache()
    print(json.dumps({"nvidia_smi": smi, "sms": sms}), flush=True)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "w") as f:
            json.dump({"nvidia_smi": smi, "sms": sms, "shapes": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
