#!/usr/bin/env python3
"""Device time of K7 (sliding CMVN) and of its plain PyTorch version, on one
GPU, at the shapes ``cli.extract --cmvn device`` gives it.

    python3 scripts/time_k7.py [--reps 20] [--rounds 3] [--mix 8x500=N,8x1000=N,...]
    python3 scripts/time_k7.py --plans      # K7 at each candidate launch plan

Shapes: a batch of 8 at each extraction bucket (500-16000 frames) and one
60,000-frame utterance, 80 bins, valid counts drawn in [T/2, T], centred
300-frame window; the kernel also with norm_vars. Device milliseconds come
from torch.profiler (CUPTI) over ``--reps`` calls after a warm-up: the
kernel's own name for K7, every device kernel of the call for the plain
version. Each is measured ``--rounds`` times in turns (the spread of one
card). ``--mix`` gives K7's launches at each shape (``chip_smoke.py``'s
``k7_launches_by_shape``); the line then also holds their sum of device
time. Prints one JSON line with the card's name and power limit. The script
uses only the wrapper's public interface, so the same file times an older
tree of the port when copied into it.

``--plans`` instead times the kernel at every shape on each plan of tiles
of 128-1024 frames x groups of 8 or 16 bins (launched through the C entry
with that plan, held against the plain version), one JSON line a plan:
what ``ops/cmvn.py:sliding_cmvn_plan`` chooses from.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn  # noqa: E402

SHAPES = [(8, t) for t in (500, 1000, 2000, 4000, 8000, 16000)] + [(1, 60000)]
FEAT_DIM = 80


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


def parse_mix(text: str) -> dict:
    mix = {}
    for item in filter(None, text.split(",")):
        shape, count = item.split("=")
        mix[shape.strip()] = int(count)
    return mix


def time_plans(inputs, reps: int, smi: str) -> None:
    """K7 at each (tt, fb) plan of every shape, centred CMN and norm_vars."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels

    dev = torch.device("cuda")
    for key, (x, n) in inputs.items():
        b, t, f = x.shape
        for norm_vars in (False, True):
            want = cmvn.sliding_cmvn_reference(x, n, norm_vars=norm_vars)
            chosen = cmvn.sliding_cmvn_plan(b, t, f, 300, True, norm_vars, 100,
                                            kernels.num_sms(dev))
            for tt in (128, 256, 512, 1024):
                for fb in (8, 16):
                    if tt > t:
                        continue
                    rows = cmvn.extent_rows(t, tt, 300, True, 100)
                    smem = cmvn._k7_smem(rows, fb, cmvn.K7_SEG, True, norm_vars)
                    out = torch.empty_like(x)

                    def run():
                        kernels.SLIDING_CMVN.launch(
                            "sliding_cmvn", dev, x.data_ptr(), n.data_ptr(), out.data_ptr(), b,
                            t, f, 300, 1, int(norm_vars), 100, tt, fb, cmvn.K7_SEG, 1, smem)

                    ms = device_ms(run, "sliding_cmvn_kernel", reps)
                    print(json.dumps({
                        "shape": key, "norm_vars": norm_vars, "tt": tt, "fb": fb, "smem": smem,
                        "grid": b * -(-t // tt) * -(-f // fb), "device_ms": ms,
                        "max_abs_err": float((out - want).abs().max()),
                        "chosen": (chosen["tt"], chosen["fb"]) == (tt, fb), "card": smi}),
                        flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--mix", type=parse_mix, default={},
                   help="launches by shape, e.g. 8x500=40,8x1000=61")
    p.add_argument("--plans", action="store_true",
                   help="time every candidate (tt, fb) plan instead")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k7: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    unknown = set(args.mix) - {f"{b}x{t}" for b, t in SHAPES}
    if unknown:
        print(f"time_k7: --mix names shapes not timed here: {sorted(unknown)}", file=sys.stderr)
        return 2

    rng = np.random.RandomState(0)
    inputs = {}
    for b, t in SHAPES:
        x = torch.from_numpy((rng.randn(b, t, FEAT_DIM) * 3 + 12).astype(np.float32)).to(dev)
        n = torch.from_numpy(rng.randint(t // 2, t + 1, b).astype(np.int32)).to(dev)
        inputs[f"{b}x{t}"] = (x, n)
    if args.plans:
        time_plans(inputs, args.reps, smi)
        return 0
    rows = {}
    for _ in range(args.rounds):
        for key, (x, n) in inputs.items():
            rows.setdefault(f"k7_{key}", []).append(
                device_ms(lambda: cmvn.sliding_cmvn(x, n), "sliding_cmvn_kernel", args.reps))
            rows.setdefault(f"k7_norm_vars_{key}", []).append(
                device_ms(lambda: cmvn.sliding_cmvn(x, n, norm_vars=True), "sliding_cmvn_kernel",
                          args.reps))
            rows.setdefault(f"plain_{key}", []).append(
                device_ms(lambda: cmvn.sliding_cmvn_reference(x, n), None, args.reps))
    median = {k: float(np.median(v)) for k, v in rows.items()}
    out = {"card": smi, "torch": torch.__version__, "reps": args.reps, "rounds": args.rounds,
           "device_ms": rows, "median": median}
    if args.mix:
        out["mix"] = args.mix
        out["k7_sum_ms"] = sum(c * median[f"k7_{k}"] for k, c in args.mix.items())
        out["plain_sum_ms"] = sum(c * median[f"plain_{k}"] for k, c in args.mix.items())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
