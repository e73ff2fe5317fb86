#!/usr/bin/env python3
"""Device time of K1 (FBANK) and K6 (sub-center margin + CE) and of their
plain PyTorch versions, on one GPU.

    python3 scripts/time_k1_k6.py [--reps 20] [--rounds 3] [--save K1.pt]
                                  [--compare-with K1.pt]

K1 at one wave request (batch 1) of 2 s, 8 s and 128 s, and at a
raw-training microbatch (256 crops of 80,240 samples, 500 frames) with
dither off and on (draws from ``draw_noise``, as the train step draws
them), and its plain version there with the draws (the dither rows where
the tree has dither); K6 at the training
step's calls, 4 forward + 4 backward on cos_all (2, 256, 5994) fp32. Device
milliseconds come from torch.profiler (CUPTI) over ``--reps`` calls after a
warm-up: the kernels' own names for K1 and K6, every device kernel of the
call for the plain versions. Each is measured ``--rounds`` times in turns
(the spread of one card). Prints one JSON line with the card's name and
power limit. The script uses only the wrappers' public interfaces, so the
same file times an older tree of the port when copied into it.
``--save`` writes K1's outputs at the three waves (dither off) and at the
raw microbatch (dither off and on, the same draws) to a file;
``--compare-with`` reads such a file, from another tree on the same card,
and the JSON line says whether K1's outputs are bit-equal to it (the
outputs both files hold). The line also gives the dithered variant's
median device time over the dither-off one's at the raw microbatch.
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

from voxsrc2020_speaker_verification_tpu_torch.losses.projections import (  # noqa: E402
    margin_ce, margin_ce_reference)
from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb  # noqa: E402

STEP_CALLS = 4  # microbatches a training step: one K6 forward + backward each


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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--save", default=None, help="write K1's outputs here (torch.save)")
    p.add_argument("--compare-with", default=None, help="K1's outputs from another tree")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_k1_k6: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]

    cfg = fb.FbankConfig(dither=0.0)
    rng = np.random.RandomState(0)
    waves = {s: torch.from_numpy(fb.pcm16(rng.randn(1, s * 16000) * 3000).astype(np.float32)).to(dev)
             for s in (2, 8, 128)}
    g = torch.Generator(device=dev).manual_seed(0)
    cos = (torch.rand((2, 256, 5994), generator=g, device=dev) * 2 - 1) * 0.998
    labels = torch.randint(0, 5994, (256,), generator=g, device=dev)
    dloss = torch.rand(256, generator=g, device=dev) / 256

    ci = cos.detach().requires_grad_(True)
    loss = margin_ce(ci, labels, 32.0, 0.2)[0]

    def plain_step():
        c = cos.detach().requires_grad_(True)
        margin_ce_reference(c, labels, 32.0, 0.2)[0].backward(dloss)

    rows = {k: [] for k in ("k1_2s", "k1_8s", "k1_128s", "k1_plain_8s", "k6_fwd", "k6_bwd",
                            "k6_step", "k6_plain_step")}
    raw = torch.from_numpy(fb.pcm16(rng.randn(256, 80240) * 3000).astype(np.float32)).to(dev)
    dither = hasattr(fb, "draw_noise")
    if dither:
        dcfg = fb.FbankConfig(dither=1.0)
        noise = fb.draw_noise(256, 80240, dcfg, torch.Generator(device=dev).manual_seed(0), dev)
        rows.update({k: [] for k in ("k1_raw_off", "k1_raw_dither", "k1_raw_plain_dither")})
    for _ in range(args.rounds):
        for s in (2, 8, 128):
            rows[f"k1_{s}s"].append(device_ms(lambda: fb.fbank(waves[s], cfg), "fbank", args.reps))
        rows["k1_plain_8s"].append(device_ms(lambda: fb.fbank_reference(waves[8], cfg), None,
                                             args.reps))
        if dither:
            rows["k1_raw_off"].append(device_ms(lambda: fb.fbank(raw, cfg), "fbank", args.reps))
            rows["k1_raw_dither"].append(device_ms(lambda: fb.fbank(raw, dcfg, noise), "fbank",
                                                   args.reps))
            rows["k1_raw_plain_dither"].append(device_ms(
                lambda: fb.fbank_reference(raw, dcfg, noise), None, args.reps))
        f = device_ms(lambda: margin_ce(cos, labels, 32.0, 0.2), "margin_ce_fwd", args.reps)
        b = device_ms(lambda: torch.autograd.grad(loss, [ci], dloss, retain_graph=True),
                      "margin_ce_bwd", args.reps)
        rows["k6_fwd"].append(f)
        rows["k6_bwd"].append(b)
        rows["k6_step"].append(STEP_CALLS * (f + b))
        rows["k6_plain_step"].append(STEP_CALLS * device_ms(plain_step, None, args.reps))
    outputs = {f"k1_{s}s": fb.fbank(w, cfg).cpu() for s, w in waves.items()}
    if dither:
        outputs["k1_raw_off"] = fb.fbank(raw, cfg).cpu()
        outputs["k1_raw_dither"] = fb.fbank(raw, dcfg, noise).cpu()
    ratio = None
    if dither:
        ratio = float(np.median(rows["k1_raw_dither"]) / np.median(rows["k1_raw_off"]))
    if args.save:
        torch.save(outputs, args.save)
    same = None
    if args.compare_with:
        other = torch.load(args.compare_with)
        same = {k: bool(torch.equal(v, other[k])) for k, v in outputs.items() if k in other}
    print(json.dumps({"card": smi, "torch": torch.__version__, "reps": args.reps,
                      "rounds": args.rounds, "device_ms": rows,
                      "median": {k: float(np.median(v)) for k, v in rows.items()},
                      "k1_raw_dither_over_off": ratio,
                      "k1_bit_equal_to_compared": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
