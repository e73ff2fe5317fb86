#!/usr/bin/env python3
"""Training across cards through ``cli.launch``: step time by layout, and
each layout's losses against one process on the same rows; or, with
``--extract``, extraction from a feature store over 1, 2 and 4 cards.

    python3 scripts/multi_card.py [--layouts 1 2 2x2 4] [--steps 4] [--save OUT.json]
    # rehearsal on the CPU (gloo), at a small shape:
    python3 scripts/multi_card.py --device cpu --layouts 1 2x2 --batch-size 8 \\
        --feat-length 24 --steps 2 --train-args="--float32 --num-classes 10"
    # extraction (one process, a model replica a card, each bucket batch's
    # rows split over the cards: cli.extract --num-devices N):
    python3 scripts/multi_card.py --extract [--num-devices 1 2 4] [--utterances 2048]
    python3 scripts/multi_card.py --extract --device cpu --num-devices 1 3 \\
        --utterances 12 --extract-model res2net50_w8_s6_c16   # CPU rehearsal

Extraction mode: a plain float32 Kaldi store of ``--utterances`` random
feature matrices of 2-20 s (200-2000 frames, 80-d) and an artifact of
``--extract-model`` (default res2net50_w24_s4_c32, bf16, seeded random
weights) are written at run time; for each N, ``extract_dataset`` with
``num_devices=N`` runs twice (the first pays the model build and the first
calls at each shape) and the second is timed: audio-s/s, the kernels'
launches, and each embedding's largest absolute difference and smallest
cosine against one card's.

A layout is ``P`` (P data ranks) or ``DxM`` (D data x M model ranks, the
sc_cm_linear head's classes split over M). Each one runs ``cli.launch
--num-processes D*M`` of ``cli.train --synthetic --num-workers 1`` (every
rank draws the global batch from one seeded source and keeps its block, so
every layout trains on the same rows) with the bench config
(res2net50_w8_s6_c16, B=256 x A=4, 200 frames, bf16, bn_groups 8, unless
overridden), ``--steps`` steps, each process on its own card (NCCL) where
the machine has as many cards as processes. From rank 0's
``metrics.jsonl``: the step times after the first (the host clock between
logged steps, each ending in a fetch of the loss), their median and the
trained audio-s/s; the losses and gradient norms beside the first layout's;
and from every rank's ``--print-kernel-launches`` line its launches of K5's
spanning and K6's class-sharded kernels. Prints one JSON line a layout,
then the card's name and power limit. Exits non-zero if a launch fails or a
loss is not finite.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shlex
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN_FNS = ("bn_train.bn_span_stats", "bn_train.bn_span_normalize",
            "bn_train.bn_span_bwd_reduce", "bn_train.bn_span_bwd_grad")
PARTIAL_FNS = ("margin_ce.margin_ce_partial_fwd", "margin_ce.margin_ce_partial_bwd")


def parse_layout(text: str):
    data, _, model = text.partition("x")
    return int(data), int(model or 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_layout(layout: str, args, workdir: str) -> dict:
    data, model = parse_layout(layout)
    procs = data * model
    run_dir = os.path.join(workdir, layout)
    os.makedirs(run_dir)
    exp_root = os.path.join(run_dir, "exp")
    train = ["--recipe", args.recipe, "--model", args.model, "--synthetic", "--num-workers", "1",
             "--max-steps", str(args.steps), "--log-every", "1", "--seed", "0",
             "--exp-root", exp_root, "--print-kernel-launches", "--device", args.device,
             *shlex.split(args.train_args)]
    for flag, value in (("--batch-size", args.batch_size),
                        ("--num-accumulation-steps", args.num_accumulation_steps),
                        ("--feat-length", args.feat_length), ("--bn-groups", args.bn_groups)):
        if value is not None:
            train += [flag, str(value)]
    if model > 1:
        train += ["--num-model-shards", str(model)]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "voxsrc2020_speaker_verification_tpu_torch.cli.launch",
           "--num-processes", str(procs), "--coordinator", f"localhost:{free_port()}", "--",
           *train]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=run_dir, env=env, capture_output=True, text=True,
                          timeout=args.timeout)
    wall = time.perf_counter() - t0
    outs = [proc.stdout]
    for i in range(1, procs):
        with open(os.path.join(run_dir, f"launch_rank{i}.log")) as f:
            outs.append(f.read())
    if proc.returncode != 0:
        raise SystemExit(f"multi_card: layout {layout} exited {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}\n" + "\n".join(o[-1500:] for o in outs))
    exp = [d for d, _, files in os.walk(exp_root) if "metrics.jsonl" in files][0]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    launches = [json.loads(line.split(":", 1)[1]) for o in outs for line in o.splitlines()
                if line.startswith("kernel launches:")]
    backend = [line for line in outs[0].splitlines() if line.startswith("distributed:")]
    step_s = [b["time"] - a["time"] for a, b in zip(recs, recs[1:])]
    med = statistics.median(step_s) if step_s else float("nan")
    return dict(layout=layout, processes=procs, data=data, model=model,
                backend=backend[0] if backend else "one process", wall_s=wall,
                step_ms=[1e3 * s for s in step_s], step_ms_median=1e3 * med,
                audio_s_per_s=args.audio_s_per_step / med if step_s else None,
                losses=[r["loss"] for r in recs],
                gradient_norms=[r["gradient_norm"] for r in recs],
                span_launches_by_rank=[sum(rk.get(f, 0) for f in SPAN_FNS) for rk in launches],
                partial_launches_by_rank=[sum(v for k, v in rk.items()
                                              if k.split(":")[0] in PARTIAL_FNS)
                                          for rk in launches])


def write_store(root: str, utterances: int, seed: int = 0):
    """A plain Kaldi store (fbank80.ark/.scp) of random 2-20 s feature
    matrices; returns (dir, audio seconds)."""
    import numpy as np

    from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io

    os.makedirs(root)
    rng = np.random.RandomState(seed)
    frames = 0
    with kaldi_io.ArkScpWriter(os.path.join(root, "fbank80.ark"),
                               os.path.join(root, "fbank80.scp")) as w:
        for i in range(utterances):
            t = int(rng.randint(200, 2001))
            w.write(f"spk{i % 50:03d}-utt{i:05d}", (rng.randn(t, 80) * 2 + 8).astype(np.float32))
            frames += t
    return root, frames / 100.0


def block_forward_ms(artifact: str, n: int, device: str, reps: int = 10) -> dict:
    """One card's forward at its block of a 1000-frame bucket batch (the
    model's default batch over ``n`` cards, rounded up): {rows, ms} by CUDA
    events on the first card (host clock on the CPU), after a warm-up."""
    import torch

    from voxsrc2020_speaker_verification_tpu_torch.eval.export import load_inference_artifact
    from voxsrc2020_speaker_verification_tpu_torch.eval.extract import (
        default_batch_size, round_up_batch)

    dev = torch.device("cpu" if device == "cpu" else "cuda:0")
    config, embed = load_inference_artifact(artifact, dev)
    rows = round_up_batch(default_batch_size(config.model), n) // n
    feats = torch.randn(rows, 1000, config.feat_dim, device=dev)
    mask = torch.ones(rows, 1000, device=dev)
    embed(feats, mask)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            embed(feats, mask)
        end.record()
        end.synchronize()
        return {"rows": rows, "frames": 1000, "ms": start.elapsed_time(end) / reps}
    t0 = time.perf_counter()
    for _ in range(reps):
        embed(feats, mask)
    return {"rows": rows, "frames": 1000, "ms": 1e3 * (time.perf_counter() - t0) / reps}


def run_extract(args, workdir: str) -> list:
    import numpy as np
    import torch

    from voxsrc2020_speaker_verification_tpu_torch import kernels, set_float32_precision
    from voxsrc2020_speaker_verification_tpu_torch.cli.extract import extract_dataset
    from voxsrc2020_speaker_verification_tpu_torch.convert import init_weights
    from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import save_inference_artifact
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe

    set_float32_precision()
    config, _ = get_recipe("res2net_vox2_dev_aug", model=args.extract_model)
    weights = init_weights(config, torch.Generator().manual_seed(0))
    artifact = save_inference_artifact(config, weights, os.path.join(workdir, "artifact"))
    store, audio_s = write_store(os.path.join(workdir, "store"), args.utterances)
    lines, first = [], None
    for n in args.num_devices:
        runs = []
        for rep in range(2):
            if args.device != "cpu":
                torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            scp = extract_dataset(artifact, store, os.path.join(workdir, f"xv{n}_{rep}"),
                                  num_devices=n, device=args.device, progress_every=0)
            if args.device != "cpu":
                torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, kernels.launch_counts()))
        vectors = dict(kaldi_io.read_vec_flt_scp(scp))
        first = first or vectors
        gap = max(float(np.abs(vectors[u] - first[u]).max()) for u in first)
        cos = min(float(vectors[u] @ first[u] / (np.linalg.norm(vectors[u])
                                                 * np.linalg.norm(first[u]))) for u in first)
        line = dict(mode="extract", model=args.extract_model, num_devices=n,
                    block_forward_ms=block_forward_ms(artifact, n, args.device),
                    utterances=len(vectors), audio_s=audio_s,
                    seconds=[r[0] for r in runs], audio_s_per_s=audio_s / runs[1][0],
                    launches=runs[1][1], max_abs_vs_first=gap, min_cos_vs_first=cos,
                    first=args.num_devices[0])
        print(json.dumps(line), flush=True)
        lines.append(line)
        if not all(np.isfinite(v).all() for v in vectors.values()):
            raise SystemExit(f"multi_card: non-finite embeddings at {n} devices")
    return lines


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--extract", action="store_true",
                   help="extraction over --num-devices cards instead of training layouts")
    p.add_argument("--num-devices", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--utterances", type=int, default=2048)
    p.add_argument("--extract-model", default="res2net50_w24_s4_c32")
    p.add_argument("--layouts", nargs="+", default=["1", "2", "2x2", "4"])
    p.add_argument("--recipe", default="res2net_vox2_dev_aug")
    p.add_argument("--model", default="res2net50_w8_s6_c16")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-accumulation-steps", type=int, default=None)
    p.add_argument("--feat-length", type=int, default=None)
    p.add_argument("--bn-groups", type=int, default=None)
    p.add_argument("--train-args", default="",
                   help="more cli.train flags, one string (--train-args='--float32')")
    p.add_argument("--timeout", type=int, default=900)
    p.add_argument("--save", default=None)
    args = p.parse_args()

    sys.path.insert(0, REPO)
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe

    if args.extract:
        with tempfile.TemporaryDirectory() as workdir:
            lines = run_extract(args, workdir)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip() if args.device != "cpu" else "cpu"
        print(json.dumps({"card": smi}), flush=True)
        if args.save:
            with open(args.save, "w") as f:
                json.dump({"card": smi, "extract": lines}, f, indent=1)
        return 0

    overrides = {k: v for k, v in (("batch_size", args.batch_size),
                                   ("num_accumulation_steps", args.num_accumulation_steps),
                                   ("feat_length", args.feat_length)) if v is not None}
    config, _ = get_recipe(args.recipe, model=args.model, **overrides)
    args.audio_s_per_step = config.effective_batch * config.feat_length / 100.0
    if args.device != "cpu":
        from voxsrc2020_speaker_verification_tpu_torch import kernels
        kernels.build_all()  # once, before the processes load the libraries
    lines = []
    with tempfile.TemporaryDirectory() as workdir:
        for layout in args.layouts:
            line = run_layout(layout, args, workdir)
            if lines:
                ref = lines[0]
                line["loss_vs_first_layout"] = [abs(a - b) / abs(b) for a, b in
                                                zip(line["losses"], ref["losses"])]
                line["gradient_norm_vs_first_layout"] = [
                    abs(a - b) / abs(b) for a, b in zip(line["gradient_norms"],
                                                        ref["gradient_norms"])]
            print(json.dumps(line), flush=True)
            lines.append(line)
            if not all(math.isfinite(x) for x in line["losses"]):
                print(f"multi_card: non-finite loss in layout {layout}", file=sys.stderr)
                return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip() if args.device != "cpu" \
        else "cpu"
    print(json.dumps({"card": smi}), flush=True)
    if args.save:
        with open(args.save, "w") as f:
            json.dump({"card": smi, "layouts": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
