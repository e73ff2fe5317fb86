#!/usr/bin/env python3
"""Hashes of K3's and K5's outputs on seeded inputs on one GPU: to show
that two trees of the port give them bit for bit (copy this script into the
other tree and run both).

    python3 scripts/bn_outputs_hash.py --save a.json
    python3 scripts/bn_outputs_hash.py --compare-with a.json

Cases: K3 (``ops.bn_act``) with relu and mask, a raw and a normalized
shortcut, in float32 and bfloat16, at channel counts that are multiples of
4 and at dpn68's 10-channel stem (256, 10, 200, 80) (each element's
arithmetic is the same on every K3 path); K5 (``ops.bn_train``) forward
output, input gradients and running statistics under relu with each
shortcut mode, on the cluster design (4-D) and the 2-D design (the
multi-kernel design before slice 19, the head design since), groups 8, at
channel counts that fill 16-byte vectors; and every K5
call of the bench training step (res2net50_w8_s6_c16, B = 256, 200 frames,
bf16, bn_groups 8: ``chip_smoke.train_shapes``) with its relu and shortcut
mode. The script uses only the wrappers' public interface. Prints one JSON
line: the SHA-256 of each output's bytes, and with ``--compare-with``
whether every one equals the other file's (exit 1 if not).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops  # noqa: E402

K3_SHAPES = ((64, 96, 200, 80), (32, 1024, 125, 10), (16, 32, 37, 11), (256, 10, 200, 80))
K5_SHAPES = (((64, 48, 200, 80), 8), ((32, 64, 25, 10), 8), ((256, 3072), 8), ((64, 40), 8))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()


def inputs(shape, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if x.ndim == 4 else x


def k5_digests(shape, groups, dtype, mode, relu, dev):
    """Digests of K5's y, input gradients and running statistics at one
    call (shortcut ``mode`` 0, 1 raw or 2 normalized)."""
    c = shape[1]
    x, s, dy = (inputs(shape, dtype, seed, dev) for seed in (4, 5, 6))
    g = torch.Generator(device=dev).manual_seed(7)
    stats = [0.1 * torch.randn(c, generator=g, device=dev), 0.5 + torch.rand(c, generator=g, device=dev)] * 2
    stats = [t.clone() for t in stats]
    xi, si = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    kw = dict(groups=groups, relu=relu)
    if mode:
        kw["shortcut"] = si
    if mode == 2:
        kw.update(shortcut_running_mean=stats[2], shortcut_running_var=stats[3])
    y = ops.bn_train(xi, stats[0], stats[1], **kw)
    y.backward(dy)
    parts = [y, xi.grad] + ([si.grad] if mode else []) + stats
    return [digest(t) for t in parts]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--save", default=None)
    p.add_argument("--compare-with", default=None)
    args = p.parse_args()
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for shape in K3_SHAPES:
            c, t = shape[1], shape[2]
            x, s = inputs(shape, dtype, 1, dev), inputs(shape, dtype, 2, dev)
            g = torch.Generator(device=dev).manual_seed(3)
            m, v = 0.1 * torch.randn(c, generator=g, device=dev), 0.5 + torch.rand(c, generator=g, device=dev)
            mask = (torch.arange(t, device=dev)[None] < torch.randint(
                1, t + 1, (shape[0],), generator=g, device=dev)[:, None]).float()
            for name, kw in (("relu_mask", dict(relu=True, mask=mask)), ("raw", dict(shortcut=s)),
                             ("normalized", dict(relu=True, shortcut=s, shortcut_mean=m,
                                                 shortcut_var=v, mask=mask))):
                out[f"bn_act/{dn}/{shape}/{name}"] = digest(ops.bn_act(x, m, v, **kw))
        for shape, groups in K5_SHAPES:
            for mode in (0, 1, 2):
                out[f"bn_train/{dn}/{shape}/g{groups}/mode{mode}"] = k5_digests(
                    shape, groups, dtype, mode, True, dev)
    # the bench training step's K5 calls
    k5, _ = chip_smoke.train_shapes(RES2NET_CONFIGS["res2net50_w8_s6_c16"], 256, 200, 80)
    for shape, relu, mode in sorted(k5):
        out[f"bench_step/{shape}/relu{int(relu)}/mode{mode}"] = k5_digests(
            shape, 8, torch.bfloat16, mode, relu, dev)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    line = {"cases": len(out)}
    if args.compare_with:
        with open(args.compare_with) as f:
            other = json.load(f)
        differ = sorted(k for k in out if other.get(k) != out[k])
        line.update(compared=len(out), bit_equal=not differ, differ=differ)
    if args.save:
        with open(args.save, "w") as f:
            json.dump(out, f)
    print(json.dumps(line), flush=True)
    return 1 if args.compare_with and line["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
