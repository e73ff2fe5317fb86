#!/usr/bin/env python3
"""Phase profile of K1's fast design (csrc/fbank.cu) at the raw-training
microbatch (256 crops of 80,240 samples, 500 frames, 80 bins), dither off
and on, on one GPU.

    python3 scripts/profile_k1.py [--calls 10] [--probe] [--save OUT.json]

Builds csrc/fbank.cu once more with -DVSV_K1_PROF (into the kernels' build
directory, beside the normal library), whose fast kernel has lane 0 of
every warp lap clock64 into seven phases: the tile's samples landing
(wait), staging the dithered samples (stage: issuing the draws' loads,
the adds and stores), waiting for the draws' loads to land (draws), the
FMA loop (fma), the warps' meeting after it (join), the previous tile's
mel (mel) and the merge and send of the power (merge). Prints one JSON
line: per variant, each phase's microseconds a warp over one call (the sum
over warps / warps / calls, at the card's maximum SM clock), the call's
time by CUDA events with the hooks on, and the card's name and power
limit. The hooks cost time of their own; compare phases, not totals, with
the normal build's device time (scripts/time_k1_k6.py).

``--probe`` also builds a copy of csrc/fbank.cu whose dithered loop loads
no draws (each draw replaced by a value computed from its indices: wrong
outputs, the same staging otherwise) and times the dithered call, device
ms by CUDA events, on the normal build and on the probe in turns: what the
draws' loads from L2 cost, hence the most that staging them another way
(once a cluster, by tensor copies) could save.
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

PHASES = ("wait", "stage", "draws", "fma", "join", "mel", "merge")
# the dithered loop's load of one draw, and what the probe computes instead
DRAW_LOAD = "__ldg(nrow + noff[m] + rn)"
PROBE_DRAW = "0.25f * (m + rn)"


def build(kernels, source: str, out: str, *flags: str) -> None:
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", kernels.CSRC_DIR,
                    "-o", out, source], check=True)


def events_ms(call, calls: int) -> float:
    call()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--probe", action="store_true",
                   help="also time a build that loads no draws (see above)")
    p.add_argument("--save", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_k1: needs a CUDA GPU", file=sys.stderr)
        return 2
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    normal_path = kernels.FBANK.library_path()
    kernels.FBANK.finish_build(kernels.FBANK.start_build())
    lib_path = os.path.join(kernels.BUILD_DIR, "fbank_prof.so")
    build(kernels, kernels.FBANK.source_path, lib_path, "-DVSV_K1_PROF")
    probe_path = os.path.join(kernels.BUILD_DIR, "fbank_probe.so")
    if args.probe:
        with open(kernels.FBANK.source_path) as f:
            text = f.read()
        if text.count(DRAW_LOAD) != 1:
            print(f"profile_k1: {DRAW_LOAD!r} is not in the source once", file=sys.stderr)
            return 2
        src = os.path.join(kernels.BUILD_DIR, "fbank_probe.cu")
        with open(src, "w") as f:
            f.write(text.replace(DRAW_LOAD, PROBE_DRAW))
        build(kernels, src, probe_path)

    def use(path):
        kernels.FBANK.library_path = lambda: path
        kernels.FBANK._lib = None
        return kernels.FBANK.load()

    lib = use(lib_path)
    lib.fbank_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    slots = len(PHASES) + 1
    sums = np.zeros(2 * slots, np.uint64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1])
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    raw = torch.from_numpy(fb.pcm16(rng.randn(256, 80240) * 3000).astype(np.float32)).to(dev)
    dcfg, cfg = fb.FbankConfig(dither=1.0), fb.FbankConfig(dither=0.0)
    noise = fb.draw_noise(256, 80240, dcfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {"card": smi, "calls": args.calls}
    for variant, call in ((0, lambda: fb.fbank(raw, cfg)), (1, lambda: fb.fbank(raw, dcfg, noise))):
        call()
        torch.cuda.synchronize()
        lib.fbank_prof(sums.ctypes.data, 1)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.calls):
            call()
        b.record()
        b.synchronize()
        lib.fbank_prof(sums.ctypes.data, 1)
        v = sums[variant * slots:(variant + 1) * slots].astype(np.float64)
        warps = v[-1] / args.calls
        out["dither" if variant else "off"] = {
            "warps": warps, "ms_hooks_on": a.elapsed_time(b) / args.calls,
            "us_a_warp": {ph: v[i] / args.calls / warps / mhz for i, ph in enumerate(PHASES)}}
    if args.probe:
        times = {"normal": [], "probe": []}
        for _ in range(3):
            for name, path in (("normal", normal_path), ("probe", probe_path)):
                use(path)
                times[name].append(events_ms(lambda: fb.fbank(raw, dcfg, noise), args.calls))
        out["probe_dither_ms"] = times
    line = json.dumps(out)
    if args.save:
        with open(args.save, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
