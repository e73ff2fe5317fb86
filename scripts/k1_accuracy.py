#!/usr/bin/env python3
"""K1 (FBANK) and its plain version against float64 on raw-training crops,
on one GPU.

    python3 scripts/k1_accuracy.py [--batches 3] [--workers 6]

Writes chip_smoke.py's raw-phase data (600 synthetic speech-like utterances,
a quarter reverb + noise specs) to a temporary directory, draws
``--batches`` optimizer-step batches (4 microbatches of 256 crops of 80,240
samples, 500 frames) from the native raw feeder with ``--workers`` threads,
and for each microbatch runs K1 with dither 1.0 (draws from a seeded
generator), with dither off, and with dither off on the wave plus one
draw a sample (``wave_dither``), its plain float32 version and a float64
run of the same function (``chip_smoke.fbank_float64``). Prints one JSON
line a microbatch: the largest |kernel - plain|, |kernel - float64| and
|plain - float64| in log-mel over all frames and over the valid frames, the
mel bin and value of the largest |kernel - plain|, and whether K1 dithered
with the per-sample draw framed (``noise[b, t, i] = u[b, t * shift + i]``)
is bit-equal to K1 on the wave plus u; then one summary line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.data.native import (  # noqa: E402
    NativeRawBatchFeeder)
from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import pipeline  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.utils.datadir import load_utt2id  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--workers", type=int, default=6)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("k1_accuracy: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as workdir:
        data, *_ = chip_smoke.write_raw_data(os.path.join(workdir, "raw"), chip_smoke.SEED + 51)
        feeder = NativeRawBatchFeeder(os.path.join(data, "wav.scp"),
                                      load_utt2id(os.path.join(data, "utt2id.pkl")), 200, 256, 4,
                                      context=150, num_threads=args.workers, seed=1)
        try:
            batches = [feeder.get()[0] for _ in range(args.batches)]
        finally:
            feeder.close()
    cfgs = {"dither": fb.FbankConfig(dither=1.0), "off": fb.FbankConfig(dither=0.0)}
    ratios = []
    for k, (waves, ns, _, _) in enumerate(batches):
        for a in range(waves.shape[0]):
            w = torch.from_numpy(waves[a]).to(dev).float()
            valid = pipeline.num_frames_batch(torch.from_numpy(ns[a]).to(dev), cfgs["off"])
            g = torch.Generator(device=dev).manual_seed(100 * k + a)
            noise = fb.draw_noise(*w.shape, cfgs["dither"], g, dev)
            inside = (torch.arange(noise.shape[1], device=dev)[None] < valid[:, None])[..., None]
            row = {"batch": k, "microbatch": a}
            u = torch.randn(w.shape, generator=g, device=dev)
            framed = u.unfold(1, 400, 160)[:, :noise.shape[1]].contiguous()
            row["framed_draws_bit_equal_to_dithered_wave"] = bool(torch.equal(
                fb.fbank(w, cfgs["dither"], framed), fb.fbank(w + u, cfgs["off"])))
            for name, cfg in (*cfgs.items(), ("wave_dither", cfgs["off"])):
                nz = noise if name == "dither" else None
                x = w + u if name == "wave_dither" else w
                kern, plain = fb.fbank(x, cfg, nz), fb.fbank_reference(x, cfg, nz)
                exact = chip_smoke.fbank_float64(x, cfg, nz)
                d = {"kernel_plain": (kern - plain).abs(), "kernel_float64": (kern - exact).abs(),
                     "plain_float64": (plain - exact).abs()}
                r = {f"{key}_max": float(v.max()) for key, v in d.items()}
                r.update({f"{key}_valid_max": float((v * inside).max()) for key, v in d.items()})
                i = int(d["kernel_plain"].argmax())
                r["worst_bin"], r["worst_value"] = i % cfg.num_bins, float(exact.flatten()[i])
                ratios.append(r["kernel_float64_max"]
                              / max(chip_smoke.TOL_FBANK, r["plain_float64_max"]))
                row[name] = r
            print(json.dumps(row), flush=True)
    print(json.dumps({"card": smi, "torch": torch.__version__, "batches": args.batches,
                      "workers": args.workers, "microbatches": len(ratios) // 3,
                      "max_kernel_float64_over_max_tol_plain": max(ratios)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
