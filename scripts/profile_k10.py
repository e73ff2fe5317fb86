#!/usr/bin/env python3
"""Where K10 (the stride-2 split stage in eval) spends its time, by phase,
on a GPU.

    python3 scripts/profile_k10.py [--tree DIR] [--label L] [--save OUT.json]

Builds csrc/split_stride2.cu once more with -DVSV_K10_PROF (into the
kernels' build directory), so that the first consumer thread and the
producer warp's first lane of each CTA lap clock64 into their phases and
add them to a device array at their end (the first design: thread 0 of
each CTA), and runs ``split_stride2`` (bf16) once at each stride-2 stage of
``scripts/time_k10.py``'s forwards (B = 128, 1000 frames, the serving and
bench models). Phases: ``patch`` (waiting for a stage's x patch to land),
``weight`` (loading the weights; the first design: also waiting for a
weight slice, with its barrier), ``mma`` (the conv's tensor-core loop),
``epilogue`` (rounding, BN, relu, the output's stores, with their
barriers), ``pool`` (the last group's average pool), ``issue`` (issuing a
patch's copies: the producer warp; the first design: every thread) and
``produce_wait`` (the producer waiting for a free ring buffer). Prints one
JSON line a shape: K10's ms with the counters on (CUDA events), its conv
tiles, pool stages (the first design: pool tiles) and CTAs, and per phase
the microseconds summed over the CTAs divided by the card's SM count
(``*_us_per_sm``: the share of the launch's wall time if the CTAs spread
evenly and ran one at a time an SM) and a CTA's mean (``*_us_per_cta``),
at the card's maximum SM clock as nvidia-smi reports it; then the card's
name and power limit.

``--tree DIR`` profiles the port of another checkout whose
split_stride2.cu has the profile build. The first design's profile (commit
a3295eb) comes from that commit's source with the same hooks, which
scripts/profile_k10_parent.patch adds:

    mkdir -p _scratch/parent && git archive a3295eb | tar -x -C _scratch/parent
    patch -d _scratch/parent -p1 < scripts/profile_k10_parent.patch
    python3 scripts/profile_k10.py --tree _scratch/parent
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

from time_k10 import MODELS, stage_inputs, stride2_shapes  # noqa: E402

PHASES = ("patch", "weight", "mma", "epilogue", "pool", "issue", "produce_wait", "epi_wait",
          "epi_rows")
SLOTS = PHASES + ("tiles", "pool_tiles", "ctas")


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
    p.add_argument("--tree", default=None,
                   help="a checkout whose port (and its split_stride2.cu) to profile")
    p.add_argument("--label", default=None)
    p.add_argument("--save", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_k10: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(kernels.BUILD_DIR, "split_stride2_prof.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DVSV_K10_PROF", "-o", lib_path,
                    kernels.SPLIT_STRIDE2.source_path], check=True)
    kernels.SPLIT_STRIDE2.library_path = lambda: lib_path
    lib = kernels.SPLIT_STRIDE2.load()
    lib.split_stride2_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters = np.zeros(len(SLOTS), np.uint64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1])
    dev = torch.device("cuda")
    sms = kernels.num_sms(dev)
    label = args.label or (args.tree or "this tree")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for model in MODELS:
        for w, s, shape in stride2_shapes(RES2NET_CONFIGS, rn._strided, model, 128, 1000):
            x, weight, means, var = stage_inputs(w, s, shape, g, dev)

            def call():
                rn.split_stride2(x, weight, means, var)

            ms = events_ms(call, 5)
            torch.cuda.synchronize()
            lib.split_stride2_prof(counters.ctypes.data, 1)  # read and clear
            call()
            torch.cuda.synchronize()
            code = lib.split_stride2_prof(counters.ctypes.data, 1)
            if code:
                raise RuntimeError(f"split_stride2_prof: CUDA error {code}")
            c = counters.astype(np.float64)
            ctas = c[SLOTS.index("ctas")]
            row = {"label": label, "model": model, "width": w, "split": s, "input": list(shape),
                   "ms_instrumented": ms, "ctas": int(ctas),
                   "tiles": int(c[SLOTS.index("tiles")]),
                   "pool_tiles": int(c[SLOTS.index("pool_tiles")]),
                   "plan": {k: v for k, v in rn.stride2_plan(w, s, shape, torch.bfloat16).items()
                            if isinstance(v, (int, str))}}
            for i, ph in enumerate(PHASES):
                if c[i] and ctas:
                    row[f"{ph}_us_per_sm"] = c[i] / sms / mhz
                    row[f"{ph}_us_per_cta"] = c[i] / ctas / mhz
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x
            torch.cuda.empty_cache()
    print(json.dumps({"label": label, "nvidia_smi": smi, "sms": sms}), flush=True)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        with open(args.save, "w") as f:
            json.dump({"label": label, "nvidia_smi": smi, "sms": sms, "shapes": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
