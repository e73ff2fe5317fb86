#!/usr/bin/env python3
"""Time and profile training steps of the PyTorch port on a GPU.

    python3 scripts/profile_torch_train.py [--model res2net50_w8_s6_c16]
        [--batch 256] [--accum 4] [--frames 200] [--bn-groups 8] [--steps 3]
        [--fit-steps 0] [--host-calls 0]

Builds the training state (``training.trainer.create_train_state``, seeded
weights, bf16 compute) and runs ``make_train_step`` on one resident batch
of synthetic features (no feeder: the device work alone). Prints one JSON
line: the median step time by CUDA events, the card's name and power limit,
peak device memory, the device time per kernel name (and calls per step)
from ``torch.profiler`` over ``--steps`` steps, the share of the profiled
window the device was idle, K5's launches per step beside the device
kernels they ran (its cluster design must run one kernel per call),
K4's and K4b's and K9's and K9b's device time per step, and each stride-2
split stage of the step (``stride2_stages``): called alone in training on
the input it got in the step, its forward and its backward (the gradients
of x and of the weight) in device ms by kernel. The breakdown uses only
the module's call, so the script runs on older trees too (copy it in).

``--fit-steps N`` also trains N steps through ``training.loop.fit`` with
the CLI's synthetic feeder (the entry point users run, host-bound) and
reports its step times by the host clock, the first step left out.
``--host-calls N`` also times N forward + backward calls of the training
BN (``ops.nn.bn_train``) on a tiny input (8 groups of (1, 64, 4, 4), bf16,
relu), and of a stride-2 split stage in training (``Res2NetSplitConv(6,
16, strides=2)`` on (8, 96, 8, 8), bf16, 8 BN groups), by the host clock,
synchronizing once at the end: the device work per call is a few
microseconds, so this is the host cost of one call.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxsrc2020_speaker_verification_tpu_torch import kernels  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state, make_train_step)


# the device kernels of csrc/bn_train.cu: the cluster design's two, the
# head design's two (2-D calls), the multi-kernel design's six
K5_DEVICE_KERNELS = ("cluster_fwd_kernel", "cluster_bwd_kernel", "head_fwd_kernel",
                     "head_bwd_kernel", "stats_kernel", "finalize_fwd_kernel",
                     "normalize_kernel", "reduce_bwd_kernel", "finalize_bwd_kernel",
                     "grad_kernel")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="res2net50_w8_s6_c16")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--accum", type=int, default=4)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--bn-groups", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--fit-steps", type=int, default=0)
    p.add_argument("--host-calls", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2

    config, _ = get_recipe("res2net_vox2_dev_aug", model=args.model, batch_size=args.batch,
                           num_accumulation_steps=args.accum, feat_length=args.frames)
    state = create_train_state(config, "cuda")
    for m in state.net.modules():
        if hasattr(m, "groups") and hasattr(m, "running_mean"):
            m.groups = args.bn_groups
    step = make_train_step(config)
    g = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.rand(args.accum, args.batch, args.frames, config.feat_dim,
                       generator=g, device="cuda")
    labels = torch.randint(0, config.num_classes, (args.accum, args.batch), generator=g,
                           device="cuda")

    step(state, feats, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step(state, feats, labels)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()

    from torch.profiler import ProfilerActivity, profile

    stages = stride2_stages(state.net, lambda: step(state, feats, labels), args.steps)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, feats, labels)
        torch.cuda.synchronize()
    launches = {k: v // args.steps for k, v in kernels.function_launch_counts().items() if v}
    by_kernel, calls = {}, {}
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.key.startswith("Command Buffer"):
            continue
        by_kernel[e.key] = e.device_time_total / args.steps / 1e3
        calls[e.key] = e.count // args.steps
        busy_us += e.device_time_total
    span = [ev for ev in prof.events()
            if ev.device_type.name == "CUDA" and not ev.name.startswith("Command Buffer")]
    window_us = (max(ev.time_range.end for ev in span) - min(ev.time_range.start for ev in span)
                 if span else 0.0)
    top = {k: [v, calls[k]] for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:40]}
    # K5: its C entry points' launches per step beside the device kernels
    # they ran; the cluster design is one device kernel per call
    k5 = {}
    for k, v in by_kernel.items():
        m = re.search(r"::(\w+)[<(]", k)
        name = m.group(1) if m else k
        if name in K5_DEVICE_KERNELS:
            ms, n = k5.get(name, (0.0, 0))
            k5[name] = (ms + v, n + calls[k])
    # the cluster design's launches on rows and on folded rows
    one_launch = all(k5.get(f"cluster_{d}_kernel", (0, 0))[1] == sum(
        launches.get(f"bn_train.bn_cluster_{d}:{p}", 0) for p in ("row", "fold"))
        for d in ("fwd", "bwd"))
    extra = {}
    if args.host_calls:
        extra["k5_host_us_per_call"] = host_us_per_bn_call(args.host_calls)
        extra["stride2_host_us_per_call"] = host_us_per_stride2_call(args.host_calls)
    if args.fit_steps:
        del state, step, feats, labels
        torch.cuda.empty_cache()
        extra["fit_step_ms"] = fit_step_ms(config, args.bn_groups, args.fit_steps)
        extra["fit_step_ms_median"] = statistics.median(extra["fit_step_ms"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    med = statistics.median(times)
    print(json.dumps({
        "model": args.model, "batch": args.batch, "accum": args.accum, "frames": args.frames,
        "bn_groups": args.bn_groups, "dtype": "bfloat16",
        "step_ms_median": med, "step_ms_all": times,
        "audio_s_per_s": args.batch * args.accum * args.frames / 100.0 / (med / 1e3),
        "peak_memory_bytes": peak,
        "device_ms_per_step": busy_us / args.steps / 1e3,
        "device_idle_share": (1.0 - busy_us / window_us) if window_us else None,
        "device_ms_and_calls_by_kernel": top, "launches_per_step": launches,
        "k5_device_ms_and_calls": k5, "k5_cluster_calls_one_kernel_each": one_launch,
        # K4 and K4b (csrc/stats_pool*.cu) and K9 / K9b (csrc/split_train.cu)
        # by device kernel name
        "k4_k4b_device_ms_and_calls": {k: [v, calls[k]] for k, v in by_kernel.items()
                                       if "stats_pool" in k},
        "k9_k9b_device_ms_and_calls": {k: [v, calls[k]] for k, v in by_kernel.items()
                                       if "k9_" in k or "k9b_" in k},
        "stride2_stages": stages,
        "stride2_device_ms_per_step": args.accum * sum(
            st["fwd"]["device_ms"] + st["bwd"]["device_ms"] for st in stages),
        **extra, "nvidia_smi": smi,
    }))
    return 0


def stride2_stages(net, run_step, reps):
    """Each stride-2 split stage of the step, called alone in training on the
    input it got in the step's first microbatch (a forward pre-hook), its BN
    statistics restored after: the forward (no autograd graph) and the
    backward (the gradients of x and of the weight for a fixed cotangent,
    the forward's graph kept) each by CUDA events and in device ms by
    torch.profiler, summed and by kernel (the ten largest)."""
    from torch.profiler import ProfilerActivity, profile

    mods = [m for m in net.modules()
            if type(m).__name__ == "Res2NetSplitConv" and m.strides == 2]
    inputs = {}

    def keep(mod, args):
        inputs.setdefault(id(mod), (args[0].detach().clone(), *args[1:]))

    hooks = [m.register_forward_pre_hook(keep) for m in mods]
    run_step()
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()

    def measure(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.device_time_total / reps / 1e3 for e in prof.key_averages()
              if e.device_type.name == "CUDA" and not e.key.startswith("Command Buffer")}
        return {"events_ms": a.elapsed_time(b) / reps, "device_ms": sum(by.values()),
                "by_kernel": dict(sorted(by.items(), key=lambda kv: -kv[1])[:10])}

    out = []
    for m in mods:
        x, *rest = inputs.pop(id(m))
        mask = rest[1] if len(rest) > 1 else None
        saved = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
        g = torch.Generator(device="cuda").manual_seed(2)
        with torch.no_grad():
            fwd = measure(lambda: m(x, True, mask))
        xl = x.detach().requires_grad_(True)
        y = m(xl, True, mask)
        dy = torch.randn(y.shape, generator=g, device="cuda").to(y.dtype).contiguous(
            memory_format=torch.channels_last)
        params = [xl, m.weight]
        bwd = measure(lambda: torch.autograd.grad(y, params, dy, retain_graph=True))
        m.load_state_dict(saved, strict=False)
        out.append({"width": m.width, "split": m.split, "input": list(x.shape),
                    "output": list(y.shape), "fwd": fwd, "bwd": bwd})
        del x, xl, y, dy, params
        torch.cuda.empty_cache()
    return out


def host_us_per_bn_call(n: int) -> float:
    """Host microseconds per forward + backward call of the training BN on
    a tiny input, the device queue never the limit."""
    import time

    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    g = torch.Generator(device="cuda").manual_seed(1)
    x, dy = (torch.randn(8, 64, 4, 4, generator=g, device="cuda").bfloat16()
             .contiguous(memory_format=torch.channels_last) for _ in range(2))
    rm, rv = torch.zeros(64, device="cuda"), torch.ones(64, device="cuda")

    def call():
        xi = x.detach().requires_grad_(True)
        ops.bn_train(xi, rm, rv, groups=8, relu=True).backward(dy)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def host_us_per_stride2_call(n: int) -> float:
    """Host microseconds per forward + backward call of a stride-2 split
    stage in training on a tiny input, the device queue never the limit
    (only the module's call: it times whatever route the tree takes)."""
    import time

    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import Res2NetSplitConv

    stage = Res2NetSplitConv(6, 16, 2).cuda()
    for bn in stage._bns():
        bn.groups = 8
    with torch.no_grad():
        stage.weight.normal_(0, 0.1)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(8, 96, 8, 8, generator=g, device="cuda").bfloat16().contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(8, 96, 4, 4, generator=g, device="cuda").bfloat16().contiguous(
        memory_format=torch.channels_last)

    def call():
        stage(x.detach().requires_grad_(True), True).backward(dy)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def fit_step_ms(config, bn_groups: int, steps: int) -> list:
    """Host-clock ms of each step after the first of ``steps`` steps of
    ``training.loop.fit`` fed by the synthetic feeder, as the CLI runs it."""
    from voxsrc2020_speaker_verification_tpu_torch.data.dataset import (
        BatchFeeder, SyntheticDataset)
    from voxsrc2020_speaker_verification_tpu_torch.training.loop import fit

    state = create_train_state(config, "cuda")
    for m in state.net.modules():
        if hasattr(m, "groups") and hasattr(m, "running_mean"):
            m.groups = bn_groups
    feeder = BatchFeeder([SyntheticDataset(config.feat_dim, config.feat_length,
                                           config.num_classes, seed=i) for i in range(4)],
                         config.batch_size, config.num_accumulation_steps).start()
    try:
        hist = fit(config, feeder, log_every=1, log_fn=lambda line: None, max_steps=steps,
                   checkpoint=False, device="cuda", state=state).history
    finally:
        feeder.stop()
    return [1e3 * (b["time"] - a["time"]) for a, b in zip(hist, hist[1:])]


if __name__ == "__main__":
    sys.exit(main())
