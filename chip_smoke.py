#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repo root; needs CUDA + nvcc

Phases, one JSON line each:

1. device  -- the card's name and power limit (``nvidia-smi``);
2. build   -- nvcc builds the four kernels from ``csrc/`` (in parallel);
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the shapes the serving forward gives it (res2net50_w24_s4_c32, B=128,
   1000 frames), in float32 (TF32 off) and in bfloat16, with timings;
4. serve   -- res2net50_w24_s4_c32 at full width, bf16, random weights from
   a seed, served over TCP by ``cli.serve.make_server``; feature, wave and
   score requests from four client threads; served embeddings checked
   against offline extraction, wave against feature requests, and a small
   batch against the CPU plain path; every kernel's launch count must rise.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that line. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
BATCH, FRAMES, FEAT_DIM = 128, 1000, 80
MODEL = "res2net50_w24_s4_c32"
# peaks of one H100 SXM (dense): HBM bytes/s, and FLOP/s by operand type
# (float32 on the CUDA cores, bfloat16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# stated tolerances: fp32 kernel vs fp32 plain (relative to the output's
# largest magnitude), bf16 kernel vs fp32 plain on the same bf16 inputs
TOL_FBANK = 1e-3          # absolute, log-mel
TOL_FP32 = 1e-4
TOL_BF16 = {"split_conv": 5e-2, "bn_act": 2e-2, "stats_pool": 1e-2}
TOL_SERVED_COS = 0.9999   # served vs offline / wave vs feature embeddings
TOL_CPU_COS = 0.99        # bf16 GPU forward vs fp32 CPU plain forward


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of one call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-6))


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def lengths_mask(gen, b: int, t: int, dev) -> torch.Tensor:
    lens = torch.randint(max(1, t // 4), t + 1, (b,), generator=gen, device=dev)
    return (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()


def forward_shapes(cfg):
    """The serving forward's kernel calls at B x FRAMES: K2 per stride-1
    split stage as (width, T, F), and K3 as (C, T, F, relu, shortcut mode,
    mask), with their multiplicities."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import _strided

    t, f = FRAMES, FEAT_DIM
    k2, k3 = {}, {}

    def add(d, key):
        d[key] = d.get(key, 0) + 1

    add(k3, (cfg.num_filters[0], t, f, True, 0, True))
    for i, n in enumerate(cfg.block_sizes):
        w, s, out_c = cfg.width[i], cfg.block_strides[i], cfg.num_filters[i] * 4
        for j in range(n):
            stride = s if j == 0 else 1
            add(k3, (cfg.split * w, t, f, True, 0, True))           # bn1
            t2, f2 = _strided(t, stride), _strided(f, stride)
            if stride == 1:
                add(k2, (w, t, f))
            else:
                add(k3, (w * (cfg.split - 1), t2, f2, True, 0, False))  # split groups
            add(k3, (out_c, t2, f2, True, 2 if j == 0 else 1, True))  # bn3 + shortcut
            t, f = t2, f2
    return k2, k3, (cfg.num_filters[-1] * 4, t, f)


# ----------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------

def check_fbank(dev, gen):
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    cfg = fb.FbankConfig(num_bins=FEAT_DIM, dither=0.0)
    err = 0.0
    rng = np.random.RandomState(SEED)
    for _ in range(8):
        n = int(rng.randint(2 * 16000, 8 * 16000 + 1))
        wave = torch.from_numpy(fb.pcm16(rng.randn(n) * 3000).astype(np.float32)).to(dev)
        got, want = fb.fbank(wave[None], cfg), fb.fbank_reference(wave[None], cfg)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"fbank: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        err = max(err, abs_err(got, want))
    if err > TOL_FBANK:
        fail(f"fbank: max |kernel - plain| {err} > {TOL_FBANK}")
    # timing at one 8 s wave request
    wave = torch.from_numpy(fb.pcm16(rng.randn(8 * 16000) * 3000).astype(np.float32)).to(dev)[None]
    t = fb.num_frames(wave.shape[1], cfg)
    a, _, _ = fb.analysis_matrices(cfg)
    flops = 2 * t * a.shape[0] * a.shape[1] * 2 + 2 * t * a.shape[1] * FEAT_DIM
    nbytes = 4 * (wave.numel() + 2 * a.size + a.shape[1] * FEAT_DIM + t * FEAT_DIM)
    bms, by = bound_ms(nbytes, flops, torch.float32)
    ms = time_ms(lambda: fb.fbank(wave, cfg), reps=20)
    plain = time_ms(lambda: fb.fbank_reference(wave, cfg), reps=20)
    return dict(name="fbank", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/fbank.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/pallas/fbank.py:85 "
                         "(fbank_fused, retired in 912d3e9; = ops/fbank.py:191 fbank)",
                max_abs_err=err, tolerance=TOL_FBANK, dtype="float32",
                per="one 8 s wave request", ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)


def check_split(dev, gen, k2_calls, split):
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    err32, err16, detail = 0.0, 0.0, []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    by_ops = 0.0
    for (w, t, f), count in sorted(k2_calls.items()):
        c = split * w
        mask = lengths_mask(gen, BATCH, t, dev)
        x = torch.randn((BATCH, c, t, f), generator=gen, device=dev)
        x = (x * mask[:, None, :, None]).contiguous(memory_format=torch.channels_last)
        weight = torch.randn((w * (split - 1), w, 3, 3), generator=gen, device=dev) / math.sqrt(9 * w)
        means = [0.1 * torch.randn(w, generator=gen, device=dev) for _ in range(split - 1)]
        var = [0.5 + 1.5 * torch.rand(w, generator=gen, device=dev) for _ in range(split - 1)]
        got = rn.split_chain(x, weight, means, var, mask)
        want = rn.split_chain_reference(x, weight, means, var, mask)
        e32 = rel_err(got, want)
        xb, wb = x.bfloat16(), weight.bfloat16()
        gotb = rn.split_chain(xb, wb, means, var, mask)
        wantb = rn.split_chain_reference(xb.float(), wb.float(), means, var, mask)
        e16 = rel_err(gotb, wantb)
        del got, want, gotb, wantb, x
        flops = (split - 1) * 2 * BATCH * t * f * 9 * w * w
        nbytes = 2 * (2 * BATCH * t * f * c) + 2 * wb.numel() + 4 * BATCH * t
        bms, by = bound_ms(nbytes, flops, torch.bfloat16)
        ms = time_ms(lambda: rn.split_chain(xb, wb, means, var, mask))
        plain = time_ms(lambda: rn.split_chain_reference(xb, wb, means, var, mask))
        detail.append(dict(width=w, T=t, F=f, calls_per_forward=count, err_fp32=e32,
                           err_bf16=e16, ms_bf16=ms, plain_ms_bf16=plain, bound_ms=bms,
                           bound_by=by))
        err32, err16 = max(err32, e32), max(err16, e16)
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain
        tot["bound_ms"] += count * bms
        by_ops += count * bms if by == "operations" else 0.0
        del xb
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "split_conv", "shapes": detail})
    if err32 > TOL_FP32 or err16 > TOL_BF16["split_conv"]:
        fail(f"split_conv: rel err fp32 {err32} bf16 {err16}")
    return dict(name="split_conv", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/split_conv.cu",
                replaces="voxsrc2020_speaker_verification_tpu/models/res2net.py:82 "
                         "(Res2NetSplitConv stride-1 branch, XLA)",
                max_abs_err=err16, max_rel_err_fp32=err32, tolerance=TOL_BF16["split_conv"],
                dtype="bfloat16", per=f"B={BATCH} x {FRAMES}-frame forward", **tot,
                bound_by="operations" if by_ops * 2 > tot["bound_ms"] else "bytes",
                library_ms=None)


def check_bn_act(dev, gen, k3_calls):
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops
    import torch.nn.functional as F

    err32, err16, detail = 0.0, 0.0, []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for (c, t, f, relu, sc_mode, masked), count in sorted(k3_calls.items()):
        x = torch.randn((BATCH, c, t, f), generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)
        mean, var = 0.1 * torch.randn(c, generator=gen, device=dev), 0.5 + 1.5 * torch.rand(c, generator=gen, device=dev)
        sc = smean = svar = None
        if sc_mode:
            sc = torch.randn((BATCH, c, t, f), generator=gen, device=dev).contiguous(
                memory_format=torch.channels_last)
        if sc_mode == 2:
            smean, svar = 0.1 * torch.randn(c, generator=gen, device=dev), 0.5 + 1.5 * torch.rand(c, generator=gen, device=dev)
        mask = lengths_mask(gen, BATCH, t, dev) if masked else None
        kw = dict(relu=relu, shortcut=sc, shortcut_mean=smean, shortcut_var=svar, mask=mask)
        e32 = rel_err(ops.bn_act(x, mean, var, **kw), ops.bn_act_reference(x, mean, var, **kw))
        xb = x.bfloat16()
        kwb = dict(kw, shortcut=None if sc is None else sc.bfloat16())
        kwf = dict(kw, shortcut=None if sc is None else kwb["shortcut"].float())
        e16 = rel_err(ops.bn_act(xb, mean, var, **kwb), ops.bn_act_reference(xb.float(), mean, var, **kwf))
        nbytes = 2 * 2 * x.numel() + (2 * x.numel() if sc is not None else 0) + (4 * BATCH * t if masked else 0)
        bms, by = bound_ms(nbytes, 0.0, torch.bfloat16)
        ms = time_ms(lambda: ops.bn_act(xb, mean, var, **kwb))
        plain = time_ms(lambda: ops.bn_act_reference(xb, mean, var, **kwb))
        row = dict(C=c, T=t, F=f, relu=relu, shortcut_mode=sc_mode, mask=masked,
                   calls_per_forward=count, err_fp32=e32, err_bf16=e16, ms_bf16=ms,
                   plain_ms_bf16=plain, bound_ms=bms, bound_by=by)
        if not relu and not sc_mode and not masked:
            row["library_ms_bf16"] = time_ms(lambda: F.batch_norm(xb, mean, var, eps=ops.BN_EPSILON))
        detail.append(row)
        err32, err16 = max(err32, e32), max(err16, e16)
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain
        tot["bound_ms"] += count * bms
        del x, xb, sc, kwb, kwf, kw
        torch.cuda.empty_cache()
    # the flag-free pass is exactly one PyTorch call: F.batch_norm in eval mode
    c, t, f = next(iter(k3_calls))[:3]
    x = torch.randn((BATCH, c, t, f), generator=gen, device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    mean, var = 0.1 * torch.randn(c, generator=gen, device=dev), 0.5 + 1.5 * torch.rand(c, generator=gen, device=dev)
    e_plain = rel_err(ops.bn_act(x.float(), mean, var), F.batch_norm(x.float(), mean, var, eps=ops.BN_EPSILON))
    detail.append(dict(C=c, T=t, F=f, relu=False, shortcut_mode=0, mask=False, err_fp32=e_plain,
                       ms_bf16=time_ms(lambda: ops.bn_act(x, mean, var)),
                       library_ms_bf16=time_ms(lambda: F.batch_norm(x, mean, var, eps=ops.BN_EPSILON))))
    err32 = max(err32, e_plain)
    emit({"phase": "kernel", "name": "bn_act", "shapes": detail})
    if err32 > TOL_FP32 or err16 > TOL_BF16["bn_act"]:
        fail(f"bn_act: rel err fp32 {err32} bf16 {err16}")
    return dict(name="bn_act", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/bn_epilogue.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:206 "
                         "(BatchNorm eval branch + relu/residual/mask_time, XLA)",
                max_abs_err=err16, max_rel_err_fp32=err32, tolerance=TOL_BF16["bn_act"],
                dtype="bfloat16", per=f"B={BATCH} x {FRAMES}-frame forward", **tot,
                bound_by="bytes", library_ms=None)


def check_stats_pool(dev, gen, head_shape):
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    c, t, f = head_shape
    mask = lengths_mask(gen, BATCH, t, dev)
    x = torch.randn((BATCH, c, t, f), generator=gen, device=dev) * 3 + 1
    x = (x * mask[:, None, :, None]).contiguous(memory_format=torch.channels_last)
    e32 = rel_err(ops.stats_pool(x, mask), ops.stats_pool_reference(x, mask))
    xb = x.bfloat16()
    e16 = rel_err(ops.stats_pool(xb, mask), ops.stats_pool_reference(xb.float(), mask))
    nbytes = 2 * xb.numel() + 4 * BATCH * t + 2 * BATCH * 2 * c * f
    bms, by = bound_ms(nbytes, 3.0 * xb.numel(), torch.bfloat16)
    ms = time_ms(lambda: ops.stats_pool(xb, mask), reps=20)
    plain = time_ms(lambda: ops.stats_pool_reference(xb, mask), reps=20)
    if e32 > TOL_FP32 or e16 > TOL_BF16["stats_pool"]:
        fail(f"stats_pool: rel err fp32 {e32} bf16 {e16}")
    return dict(name="stats_pool", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/stats_pool.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:487 (stats_pool, XLA)",
                max_abs_err=e16, max_rel_err_fp32=e32, tolerance=TOL_BF16["stats_pool"],
                dtype="bfloat16", per=f"B={BATCH} head, (C, T, F)={head_shape}",
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None)


# ----------------------------------------------------------------------
# phase 4: serving over TCP
# ----------------------------------------------------------------------

def cos(a, b) -> float:
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def serve_phase(dev, workdir, per_forward):
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.cli.serve import ServingClient, make_server
    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
    from voxsrc2020_speaker_verification_tpu_torch.convert import init_weights
    from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import (
        load_inference_artifact, save_inference_artifact)
    from voxsrc2020_speaker_verification_tpu_torch.eval.extract import (
        extract_embeddings, make_bucketed_embed_fn)
    from voxsrc2020_speaker_verification_tpu_torch.ops.fbank import pcm16

    config = TrainConfig(model=MODEL, feat_dim=FEAT_DIM, bf16=True)
    state = init_weights(config, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    proj = rng.randn(config.num_centers, 256, config.num_classes).astype(np.float32)
    artifact = save_inference_artifact(config, state, os.path.join(workdir, "artifact"),
                                       projection_params={"projection": {"kernel": proj}})

    server = make_server(artifact, "127.0.0.1", 0, batch_size=BATCH,
                         buckets=(256, 512, 1000), device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    svc = server.service
    try:
        t0 = time.perf_counter()
        svc.warmup()
        warmup_s = time.perf_counter() - t0
        if len(svc._cohort) != 11988:
            fail(f"cohort has {len(svc._cohort)} rows")

        feats = [rng.randn(int(rng.randint(200, 3001)), FEAT_DIM).astype(np.float32) * 3
                 for _ in range(24)]
        waves = [pcm16(rng.randn(int(rng.randint(3 * 16000, 8 * 16000 + 1))) * 2000)
                 for _ in range(4)]
        jobs = [("feats", i) for i in range(len(feats))] + [("wave", i) for i in range(len(waves))]
        served, latency, errors = {}, [], []
        host, port = server.server_address[:2]

        def client(k):
            try:
                with ServingClient(host, port, timeout=600) as c:
                    for kind, i in jobs[k::4]:
                        t = time.perf_counter()
                        emb = (c.embed_features(feats[i]) if kind == "feats"
                               else c.embed_wave(waves[i]))
                        latency.append(time.perf_counter() - t)
                        served[(kind, i)] = emb
            except Exception as e:  # reported below; the phase then fails
                errors.append(repr(e))

        kernels.reset_launch_counts()
        flushes0 = svc.num_flushes
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        flushes = svc.num_flushes - flushes0
        if errors or any(th.is_alive() for th in threads) or len(served) != len(jobs):
            fail(f"serving requests failed: {errors}")

        # 8 score ops over TCP, 4 cosine + 4 asnorm (topk 400)
        scores = []
        with ServingClient(host, port, timeout=600) as c:
            for j in range(8):
                a, b = served[("feats", 2 * j)], served[("feats", 2 * j + 1)]
                asn = j >= 4
                s = c.score(a, b, asnorm=asn, topk=400)
                if not np.isfinite(s) or abs(s - svc.score(a, b, asnorm=asn, topk=400)) > 1e-6:
                    fail(f"score op {j}: {s}")
                scores.append(s)

        for key, emb in served.items():
            if emb.shape != (256,) or not np.isfinite(emb).all():
                fail(f"served embedding {key} has shape {emb.shape} or non-finite values")
        # served == offline extraction of the same (CMVN'd) features
        _, embed = load_inference_artifact(artifact, dev)
        fn = make_bucketed_embed_fn(embed, batch_size=BATCH)
        offline = extract_embeddings(
            fn, ((str(i), sliding_cmn_np(f)) for i, f in enumerate(feats)), batch_size=BATCH)
        cos_offline = min(cos(served[("feats", i)], offline[str(i)]) for i in range(len(feats)))
        # wave requests == feature requests for the same audio
        cos_wave = min(cos(served[("wave", i)], svc.embed_features(svc.features_from_wave(w)))
                       for i, w in enumerate(waves))
        # a small batch: bf16 GPU forward vs the float32 plain path on the CPU
        cpu_cfg = TrainConfig(model=MODEL, feat_dim=FEAT_DIM, bf16=False)
        from voxsrc2020_speaker_verification_tpu_torch.speaker_net import build_speaker_net
        cpu_net = build_speaker_net(cpu_cfg, "cpu")
        cpu_net.load_state_dict(state)
        small = np.stack([sliding_cmn_np(feats[i][:300]) for i in range(2)])
        small_mask = np.ones((2, 300), np.float32)
        small_mask[1, 250:] = 0.0
        small[1, 250:] = 0.0
        with torch.inference_mode():
            want = cpu_net.embed(torch.from_numpy(small), torch.from_numpy(small_mask)).numpy()
        got = embed(small, small_mask).cpu().numpy()
        cos_cpu = min(cos(got[i], want[i]) for i in range(2))
        if cos_offline < TOL_SERVED_COS or cos_wave < TOL_SERVED_COS or cos_cpu < TOL_CPU_COS:
            fail(f"parity: served/offline {cos_offline} wave/feats {cos_wave} gpu/cpu {cos_cpu}")
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            fail(f"kernels never launched while serving: {missing}")
        # every flush is one full-batch forward: its launches must be the
        # per-forward calls the kernel phase timed (forward_shapes)
        for name, n in per_forward.items():
            if counts[name] != flushes * n:
                fail(f"{name}: {counts[name]} launches in {flushes} forwards, "
                     f"expected {n} per forward")

        audio_s = sum(len(f) for f in feats) / 100.0 + sum(len(w) for w in waves) / 16000.0
        lat = sorted(latency)
        emit({"phase": "serve", "model": MODEL, "dtype": "bfloat16", "batch": BATCH,
              "requests": len(jobs), "score_ops": len(scores), "warmup_s": warmup_s,
              "wall_s": wall, "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
              "p50_latency_s": lat[len(lat) // 2],
              "p95_latency_s": lat[min(len(lat) - 1, int(math.ceil(0.95 * len(lat))) - 1)],
              "flushes": flushes, "launches": counts,
              "min_cos_served_vs_offline": cos_offline, "min_cos_wave_vs_feats": cos_wave,
              "min_cos_gpu_bf16_vs_cpu_fp32": cos_cpu,
              "device": torch.cuda.get_device_name(0)})
        return counts
    finally:
        server.shutdown()
        svc.close()
        server.server_close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()})

    emit({"phase": "build", "seconds": kernels.build_all(),
          "libraries": [os.path.basename(k.library_path()) for k in kernels.KERNELS]})

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = RES2NET_CONFIGS[MODEL]
    k2, k3, head = forward_shapes(cfg)
    with torch.inference_mode():
        rows = [check_fbank(dev, gen), check_split(dev, gen, k2, cfg.split),
                check_bn_act(dev, gen, k3), check_stats_pool(dev, gen, head)]
    per_forward = {"split_conv": sum(k2.values()) * (cfg.split - 1),
                   "bn_act": sum(k3.values()), "stats_pool": 1}

    with tempfile.TemporaryDirectory() as workdir:
        counts = serve_phase(dev, workdir, per_forward)
    for row in rows:
        row["launches"] = counts[row["name"]]
        if row["name"] in per_forward:
            row["launches_per_forward"] = per_forward[row["name"]]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
