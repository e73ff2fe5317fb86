#!/usr/bin/env python3
"""Where a float32 training step on the GPU strays from the float64 step: one
step of a thin variant of an encoder family (``chip_smoke.py``'s thin
variants, the train_parity configuration: sc_cm_linear head, bn_groups 2,
200 frames, step 4 epochs in) from the same weights and batch, on the card
with the port's kernels, on the card with kernels swapped for their plain
PyTorch versions, and on the CPU in float32, each against the CPU's float64
step.

    python3 scripts/parity_attribution.py [--models ecapa_thin_smoke dpn_thin_smoke]
                                          [--batches 16 64]
                                          [--cudnn default off deterministic]
                                          [--variants kernels plain_all] [--modules]

Prints one JSON line a (model, batch, cuDNN mode, variant): the parameter
update's relative L2 distance to the float64 step's, and the two parameters
that carry most of it. Variants: ``kernels``; ``plain_<name>`` with one
wrapper (``bn_train``, ``stats_pool``, ``att_pool``, ``margin_ce``) replaced
by its plain version on the card; ``plain_all`` with all four; ``cpu``.
cuDNN modes: ``default`` (the port's flags), ``off``
(``torch.backends.cudnn.enabled = False``: PyTorch's own CUDA convolutions)
and ``deterministic`` (``torch.backends.cudnn.deterministic = True``).

``--modules``: module by module, against float64 on the card. One float64
step on the card (plain versions, which take float64) records the input of
every call of a convolution, dense layer, BN, squeeze-excitation, split
stage and attentive pool of the encoder; each call is then rerun alone, in
float32 on the card (the port's kernels, each cuDNN mode) and on the CPU,
forward and backward against a seeded output gradient, and its largest
relative error (output, input and parameter gradients, each relative to the
float64 values' largest magnitude) is printed, one line a call.
``--flips``: the sign of every convolution output of the encoder (the
input of the relu that follows most of them) in the float32 step on the card
(each cuDNN mode) and on the CPU against the float64 step on the card, one
line a convolution call with flips: how many elements took the other side of
zero and the largest float64 magnitude among them; then the margin head's
choice of sub-center (the max over K of the cosines): how many (row, class)
choices differ, the largest float64 gap between the two centers among them,
and the largest cosine difference.
Then one line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch import kernels, set_float32_precision  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.losses import projections  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state, make_train_step)

WRAPPERS = {"bn_train": ops, "stats_pool": ops, "att_pool": ops, "margin_ce": projections}
CUDNN_MODES = ("default", "off", "deterministic")


@contextlib.contextmanager
def cudnn_mode(mode):
    """The cuDNN flags of one mode, restored afterwards."""
    saved = torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic
    torch.backends.cudnn.enabled = mode != "off"
    torch.backends.cudnn.deterministic = mode == "deterministic"
    try:
        yield
    finally:
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def swapped(names):
    """The named kernel wrappers replaced by their plain versions."""
    saved = {n: getattr(WRAPPERS[n], n) for n in names}
    try:
        for n in names:
            setattr(WRAPPERS[n], n, getattr(WRAPPERS[n], n + "_reference"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(WRAPPERS[n], n, fn)


def step_update(model, batch, device, dtype, on_net=None):
    """The parameter update of one step, by name (``on_net(net)`` is called
    on the network before the step)."""
    config = TrainConfig(model=model, bf16=False, batch_size=batch, num_accumulation_steps=1,
                         bn_groups=2, feat_length=chip_smoke.TRAIN_FRAMES, seed=chip_smoke.SEED)
    rng = np.random.RandomState(chip_smoke.SEED + 7)
    feats = torch.from_numpy(rng.randn(1, batch, config.feat_length, config.feat_dim)
                             .astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, config.num_classes, (1, batch)))
    state = create_train_state(config, device, seed=chip_smoke.SEED + 3)
    state.net.to(dtype)
    state.net.encoder.dtype = dtype
    state.momentum = {k: v.to(dtype) for k, v in state.momentum.items()}
    state.step = 4 * config.epoch_size
    before = {k: v.detach().cpu().double().clone() for k, v in state.params.items()}
    if on_net is not None:
        on_net(state.net)
    state, _ = make_train_step(config)(state, feats.to(device), labels.to(device))
    return {k: state.params[k].detach().cpu().double() - b for k, b in before.items()}


def distance(update, ref):
    err = torch.cat([(update[k] - ref[k]).flatten() for k in ref]).norm()
    top = sorted(((float((update[k] - ref[k]).norm()), k) for k in ref), reverse=True)[:2]
    return float(err / torch.cat([v.flatten() for v in ref.values()]).norm()), top


RECORDED = ("Conv2d", "Dense", "BatchNorm", "SqueezeExcitation", "EcapaSplitConv",
            "AttStatsPool", "Conv1dReluBn")


def record_calls(net, calls):
    """Hooks that keep, for every call of a RECORDED module of the encoder, a
    copy of the module as it was and of its inputs."""
    def hook(name):
        def fn(module, args, kwargs, output):
            calls.append((name, copy.deepcopy(module),
                          [a.detach().clone() if torch.is_tensor(a) else a for a in args],
                          {k: v.detach().clone() if torch.is_tensor(v) else v
                           for k, v in kwargs.items()}))
        return fn
    for name, module in net.named_modules():
        if type(module).__name__ in RECORDED and name.startswith("encoder"):
            module.register_forward_hook(hook(name), with_kwargs=True)


def run_call(module, args, kwargs, device, dtype, seed):
    """Forward and backward of one recorded call in ``dtype`` on ``device``
    (the first input and 4-D floating inputs differentiable, a seeded
    output gradient); returns
    the output and the gradients, float64 on the CPU."""
    m = copy.deepcopy(module).to(device=device, dtype=dtype)
    for sub in m.modules():  # the copy keeps the recording hooks: drop them
        sub._forward_hooks.clear()

    def cast(a, leaf):
        if not torch.is_tensor(a):
            return a
        a = a.to(device)
        if a.is_floating_point():
            a = a.to(dtype)
            if a.ndim == 4:
                a = a.contiguous(memory_format=torch.channels_last)
            if leaf or a.ndim == 4:
                a.requires_grad_(True)
        return a
    args = [cast(a, i == 0) for i, a in enumerate(args)]
    kwargs = {k: cast(v, False) for k, v in kwargs.items()}
    out = m(*args, **kwargs)
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(out.shape, generator=gen, dtype=torch.float64).to(device=device, dtype=dtype)
    leaves = [a for a in args if torch.is_tensor(a) and a.requires_grad] + list(m.parameters())
    grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    return [out.detach().cpu().double()] + [None if v is None else v.detach().cpu().double()
                                            for v in grads]


def rel_max(got, want):
    err = 0.0
    for a, r in zip(got, want):
        if a is None or r is None:
            continue
        err = max(err, float((a - r).abs().max() / r.abs().max().clamp(min=1e-30)))
    return err


def module_attribution(model, batch, dev, modes):
    """Every recorded call of ``model``'s encoder, rerun alone: float32 on
    the card (each cuDNN mode) and on the CPU against float64 on the card."""
    calls = []
    with swapped(tuple(WRAPPERS)):
        step_update(model, batch, dev, torch.float64, on_net=lambda net: record_calls(net, calls))
    for i, (name, module, args, kwargs) in enumerate(calls):
        with swapped(tuple(WRAPPERS)):
            ref = run_call(module, args, kwargs, dev, torch.float64, i)
        row = {"model": model, "batch": batch, "call": i, "module": name,
               "type": type(module).__name__}
        for mode in modes:
            with cudnn_mode(mode):
                row[f"card_fp32_{mode}"] = rel_max(
                    run_call(module, args, kwargs, dev, torch.float32, i), ref)
        row["cpu_fp32"] = rel_max(run_call(module, args, kwargs, torch.device("cpu"),
                                           torch.float32, i), ref)
        print(json.dumps(row), flush=True)


def record_outputs(net, outputs):
    """Hooks that keep every encoder convolution's output, float64 on the CPU."""
    for name, module in net.named_modules():
        if type(module).__name__ == "Conv2d" and name.startswith("encoder"):
            module.register_forward_hook(
                lambda m, a, out, name=name: outputs.append((name, out.detach().cpu().double())))


@contextlib.contextmanager
def recording_centers(store):
    """margin_ce records the sub-center cosines (K, B, C) it is given."""
    fn = projections.margin_ce

    def record(cos_all, *args, **kwargs):
        store.append(cos_all.detach().cpu().double())
        return fn(cos_all, *args, **kwargs)
    projections.margin_ce = record
    try:
        yield
    finally:
        projections.margin_ce = fn


def sign_flips(model, batch, dev, modes):
    """Convolution outputs whose sign differs from the float64 step's, and
    the sub-center margin head's choice of center (the max over K) where it
    differs."""
    ref, ref_cos = [], []
    with swapped(tuple(WRAPPERS)), recording_centers(ref_cos):
        step_update(model, batch, dev, torch.float64, on_net=lambda net: record_outputs(net, ref))
    runs, cos_runs = {}, {}
    for mode in modes:
        runs[f"card_fp32_{mode}"], cos_runs[f"card_fp32_{mode}"] = [], []
        with cudnn_mode(mode), recording_centers(cos_runs[f"card_fp32_{mode}"]):
            step_update(model, batch, dev, torch.float32,
                        on_net=lambda net, o=runs[f"card_fp32_{mode}"]: record_outputs(net, o))
    runs["cpu_fp32"], cos_runs["cpu_fp32"] = [], []
    with recording_centers(cos_runs["cpu_fp32"]):
        step_update(model, batch, torch.device("cpu"), torch.float32,
                    on_net=lambda net: record_outputs(net, runs["cpu_fp32"]))
    for i, (name, r) in enumerate(ref):
        row = {"model": model, "batch": batch, "conv_call": i, "module": name}
        for run, outs in runs.items():
            flip = (outs[i][1] > 0) != (r > 0)
            row[run] = [int(flip.sum()), float(r[flip].abs().max()) if flip.any() else 0.0]
        if any(row[run][0] for run in runs):
            print(json.dumps(row), flush=True)
    if ref_cos:
        r = ref_cos[0]
        gap = (r[0] - r[1]).abs() if r.shape[0] == 2 else None
        row = {"model": model, "batch": batch, "sub_center_choice": True}
        for run, cs_ in cos_runs.items():
            flip = cs_[0].argmax(dim=0) != r.argmax(dim=0)
            row[run] = [int(flip.sum()),
                        float(gap[flip].max()) if gap is not None and flip.any() else 0.0,
                        float((cs_[0] - r).abs().max())]
        print(json.dumps(row), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+", default=["ecapa_thin_smoke", "dpn_thin_smoke"])
    p.add_argument("--batches", type=int, nargs="+", default=[16, 64])
    p.add_argument("--cudnn", nargs="+", choices=CUDNN_MODES, default=["default"])
    p.add_argument("--variants", nargs="+", default=None,
                   help="kernels, plain_<wrapper>, plain_all (default: all)")
    p.add_argument("--modules", action="store_true",
                   help="module by module against float64 on the card")
    p.add_argument("--flips", action="store_true",
                   help="convolution outputs on the other side of zero from float64's")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("parity_attribution: needs a CUDA GPU", file=sys.stderr)
        return 2
    set_float32_precision()
    kernels.build_all()
    chip_smoke.register_thin_variants()
    dev = torch.device("cuda")
    variants = [("kernels", ())] + [(f"plain_{n}", (n,)) for n in WRAPPERS] + [
        ("plain_all", tuple(WRAPPERS))]
    if args.variants:
        variants = [v for v in variants if v[0] in args.variants]
    for model in args.models:
        for batch in args.batches:
            ref = step_update(model, batch, torch.device("cpu"), torch.float64)
            for mode in args.cudnn:
                for name, names in variants:
                    with cudnn_mode(mode), swapped(names):
                        update = step_update(model, batch, dev, torch.float32)
                    err, top = distance(update, ref)
                    print(json.dumps({"model": model, "batch": batch, "cudnn": mode,
                                      "variant": name, "update_rel_err_vs_float64": err,
                                      "largest": top}), flush=True)
            err, top = distance(step_update(model, batch, torch.device("cpu"), torch.float32), ref)
            print(json.dumps({"model": model, "batch": batch, "variant": "cpu",
                              "update_rel_err_vs_float64": err, "largest": top}), flush=True)
            if args.modules:
                module_attribution(model, batch, dev, args.cudnn)
            if args.flips:
                sign_flips(model, batch, dev, args.cudnn)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
