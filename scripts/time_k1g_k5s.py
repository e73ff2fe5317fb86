#!/usr/bin/env python3
"""Device time of K1's general path (FBANK at the shapes the fast design
refuses) and of K5's spanning mode (BN groups that span data ranks), with
their plain versions, on one GPU.

    python3 scripts/time_k1g_k5s.py [--reps 20] [--rounds 2] [--save OUT.pt]
                                    [--compare-with OTHER.pt] [--label L]

K1 general (``ops.fbank.fbank``, dither off): one 8 s wave at 32 kHz, one
8 s wave at 16 kHz with 64 ms frames, a batch of 8 waves of 4 s at 32 kHz,
and the 8 s 32 kHz wave dithered (``draw_noise``). K5 span
(``ops.nn.bn_span(..., group=None)``, relu, bf16, forward + backward
through autograd): a rank's half (128, 96, 200, 80) of a 256-row batch in
one BN group over two ranks (chip_smoke.py's shape), and a rank's (16, 64,
200, 80) of res2net50_w8_s6_c16's stage-1 output on 16 data ranks at
bn_groups 8 (each group spans two ranks). Device milliseconds come from
torch.profiler (CUPTI) over ``--reps`` calls after a warm-up: every device
kernel of the call, with the number of CUDA kernels a call launches (K5:
by direction). Each is measured ``--rounds`` times in turns. The script
uses only the wrappers' public interfaces, so the same file times an older
tree of the port when copied into it. ``--save`` writes the outputs (K1
general's features, K5 span's y and dx at the first batch row) to a file; ``--compare-with``
reads such a file from another tree on the same card and reports the
largest absolute difference of each output. K5's device time is also given
by kernel. Bounds: K1's fp32 FMA of the analysis and of the packed mel
weights (``mel_columns``) against the waves, A/B, the packed weights and
the features moved once; K5's 5 units of one activation (x and y in the
forward, x, dy and dx in the backward). Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops  # noqa: E402

# (name, batch-row shape of one rank, BN groups of the global batch, ranks)
SPAN_CASES = (("span_half", (128, 96, 200, 80), 1, 2), ("span_w8_16ranks", (16, 64, 200, 80), 8, 16))
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12


def by_kernel(fn, reps):
    """Device ms of one call of ``fn`` by kernel (its name's function)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            m = re.search(r"::(\w+)<", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.device_time_total / reps / 1e3
    return out


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
        print("time_k1g_k5s: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    rng = np.random.RandomState(0)

    def wave(b, seconds, rate):
        return torch.from_numpy(fb.pcm16(rng.randn(b, int(seconds * rate)) * 3000)
                                .astype(np.float32)).to(dev)

    k1 = {"k1g_32k_8s": (fb.FbankConfig(sample_rate=32000, dither=0.0), wave(1, 8, 32000)),
          "k1g_64ms_8s": (fb.FbankConfig(frame_length_ms=64.0, dither=0.0), wave(1, 8, 16000)),
          "k1g_32k_8x4s": (fb.FbankConfig(sample_rate=32000, dither=0.0), wave(8, 4, 32000))}
    dcfg = fb.FbankConfig(sample_rate=32000, dither=1.0)
    dwave = k1["k1g_32k_8s"][1]
    noise = fb.draw_noise(1, dwave.shape[1], dcfg, torch.Generator(device=dev).manual_seed(0), dev)
    calls = {name: (lambda c=cfg, w=w: fb.fbank(w, c)) for name, (cfg, w) in k1.items()}
    calls["k1g_32k_8s_dither"] = lambda: fb.fbank(dwave, dcfg, noise)
    calls["k1g_plain_32k_8s"] = lambda: fb.fbank_reference(dwave, k1["k1g_32k_8s"][0])
    bounds = {}
    for name, (cfg, w) in k1.items():
        t, nfft = fb.num_frames(w.shape[1], cfg), cfg.padded_frame_length // 2
        nnz = fb.mel_columns(fb.analysis_matrices(cfg)[2])[2].size
        flops = w.shape[0] * (4 * t * cfg.frame_length * nfft + 2 * t * nnz)
        nbytes = 4 * (w.numel() + 2 * cfg.frame_length * nfft + nnz + w.shape[0] * t * cfg.num_bins)
        bounds[name] = max(flops / PEAK_FP32, nbytes / HBM_BYTES_PER_S) * 1e3

    g = torch.Generator(device=dev).manual_seed(1)
    span = {}
    for name, shape, groups, ranks in SPAN_CASES:
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).bfloat16().contiguous(
            memory_format=torch.channels_last)
        dy = torch.randn(shape, generator=g, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last)
        rm, rv = torch.zeros(shape[1], device=dev), torch.ones(shape[1], device=dev)
        lay = ops.SpanLayout.of(x, groups, 0, ranks)
        span[name] = (x, dy, rm, rv, lay)
        # bytes: the forward reads x and writes y, the backward reads x and dy and writes dx
        bounds[name] = 5 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3

        def fwd_bwd(x=x, dy=dy, rm=rm, rv=rv, lay=lay):
            xi = x.detach().requires_grad_(True)
            y = ops.bn_span(xi, rm, rv, lay, None, relu=True)
            return y, torch.autograd.grad(y, [xi], dy)[0]

        def fwd(x=x, rm=rm, rv=rv, lay=lay):
            with torch.no_grad():
                return ops.bn_span(x, rm, rv, lay, None, relu=True)

        calls[name] = fwd_bwd
        calls[name + "_fwd"] = fwd

    rows = {k: [] for k in calls}
    kernels_a_call = {}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            ms, n = profiled(fn, args.reps)
            rows[name].append(ms)
            kernels_a_call[name] = n
    for name, _, _, _ in SPAN_CASES:  # the backward's kernels: fwd + bwd less fwd
        kernels_a_call[name + "_bwd"] = kernels_a_call[name] - kernels_a_call[name + "_fwd"]

    breakdown = {name: by_kernel(calls[name], args.reps) for name, _, _, _ in SPAN_CASES}
    outputs = {name: fb.fbank(w, cfg).cpu() for name, (cfg, w) in k1.items()}
    for name, (x, dy, rm, rv, lay) in span.items():
        y, dx = calls[name]()
        # the first batch row of each (the whole would take GBs)
        outputs[name + "_y"], outputs[name + "_dx"] = y[:1].float().cpu(), dx[:1].float().cpu()
    if args.save:
        torch.save(outputs, args.save)
    diff = None
    if args.compare_with:
        other = torch.load(args.compare_with)
        diff = {k: float((v - other[k]).abs().max()) for k, v in outputs.items() if k in other}
    print(json.dumps({"label": args.label, "card": smi, "torch": torch.__version__,
                      "reps": args.reps, "rounds": args.rounds, "device_ms": rows,
                      "median": {k: float(np.median(v)) for k, v in rows.items()},
                      "kernels_a_call": kernels_a_call, "bound_ms": bounds,
                      "span_device_ms_by_kernel": breakdown,
                      "max_abs_diff_to_compared": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
