#!/usr/bin/env python3
"""Where K2's warpgroup-MMA variant spends its time, by phase, on a GPU.

    python3 scripts/profile_k2_wgmma.py [--batch 128]

Builds csrc/split_conv.cu once more with -DVSV_WG_PROF (into the kernels'
build directory), so that one thread of each role adds the clock64 cycles
of its phases to a device array, and runs one split chain (split 4, bf16,
masked) at res2net50_w24_s4_c32's stage-3 and stage-4 grids at B x 1000
frames: (w, T, F) = (96, 250, 20) and (192, 125, 10). Prints one JSON line
a width: the chain's time with the counters on (CUDA events) and, per CTA
and launch, the microseconds (cycles at the card's maximum SM clock, as
nvidia-smi reports it) of each
consumer warpgroup's patch wait, ldmatrix, weight-slice wait, wgmma issue to
its wait and epilogue with the write-out (averaged over the two), the tiles
a warpgroup took, the producer's stage wait and copies, and the weight
thread's ring wait; then the card's name and power limit. The counters'
own cost shows as the gap to the uninstrumented time (scripts/time_k2_k8.py).
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch import kernels, set_float32_precision  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn  # noqa: E402

SLOTS = ("patch_wait", "ldmatrix", "weight_wait", "wgmma", "epilogue", "tiles",
         "producer_stage_wait", "producer_copies", "weight_thread_ring_wait")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=128)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_k2_wgmma: needs a CUDA GPU", file=sys.stderr)
        return 2
    set_float32_precision()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(kernels.BUILD_DIR, "split_conv_prof.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DVSV_WG_PROF", "-o", lib_path,
                    kernels.SPLIT_CONV.source_path], check=True)
    kernels.SPLIT_CONV.library_path = lambda: lib_path
    lib = kernels.SPLIT_CONV.load()
    lib.split_wgmma_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters = np.zeros(1024 * 16, np.uint64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sms = kernels.num_sms(dev)
    for w, t, f in ((96, 250, 20), (192, 125, 10)):
        mask = cs.lengths_mask(gen, args.batch, t, dev)
        x = (torch.randn((args.batch, 4 * w, t, f), generator=gen, device=dev)
             * mask[:, None, :, None]).bfloat16().contiguous(memory_format=torch.channels_last)
        weight = (torch.randn((3 * w, w, 3, 3), generator=gen, device=dev) / (9 * w) ** 0.5).bfloat16()
        means = [0.1 * torch.randn(w, generator=gen, device=dev) for _ in range(3)]
        var = [0.5 + 1.5 * torch.rand(w, generator=gen, device=dev) for _ in range(3)]
        call = lambda: rn.split_chain(x, weight, means, var, mask)  # noqa: E731
        call()
        torch.cuda.synchronize()
        lib.split_wgmma_prof(counters.ctypes.data, 1)  # read and clear
        ms = cs.time_ms(call, reps=1)  # a warm-up and one timed call: 6 launches
        lib.split_wgmma_prof(counters.ctypes.data, 1)
        per_cta = counters.reshape(1024, 16)[:sms].astype(np.float64).mean(axis=0) / 6
        row = {"width": w, "T": t, "F": f, "batch": args.batch, "chain_ms_instrumented": ms}
        for i, name in enumerate(SLOTS):
            if name == "tiles":
                row["tiles_per_warpgroup"] = per_cta[i] / 2
            elif i < 5:
                row[f"{name}_us"] = per_cta[i] / 2 / mhz
            else:
                row[f"{name}_us"] = per_cta[i] / mhz
        print(json.dumps(row), flush=True)
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
