#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repo root; needs CUDA + nvcc

Phases, one JSON line each:

1. device  -- the card's name and power limit (``nvidia-smi``);
2. build   -- nvcc builds the twelve kernel libraries from ``csrc/`` (in parallel);
3. kernels -- each kernel against its plain PyTorch version on the card, in
   float32 (TF32 off: ``set_float32_precision``, the CLIs' rule) and in
   bfloat16, with timings: K1-K4 at the shapes
   the serving forward gives them (res2net50_w24_s4_c32, B=128, 1000
   frames; K2's warpgroup-MMA variant at w = 96 and 192, with its kernels'
   device time per width), K4b, K5 and K6 (forward and backward, against autograd of the
   plain versions) at the shapes of the training step below; K1 also at
   wave requests of 2 s and 128 s and a batch of 3, and at 160 mel bins
   (two 128-column passes); K6 also on its streaming path (K = 2 at C =
   30000, K = 10), and K1, K4, K4b, K5 and K6 rerun bit for bit; K7
   (sliding CMVN) at cli/extract.py's buckets (8 x 500-16000 frames, padded
   rows) and one 60,000-frame utterance against float64, rerun bit for bit;
   K8 / K8b (attentive pooling) at res2net200_att's serving and training
   heads, ECAPA-512's and a ragged shape (ATT_SHAPES), with a row masked
   throughout, a constant row and reruns; K3 / K5 at channel counts that are
   not multiples of 4 and at dpn68's stem (ANY_C, DPN_STEM), on the design
   each plan gives them (ANY_C_DESIGNS: folded 16-byte rows at the stem;
   rows ``bn_act:fold`` and ``bn_train:fold``, their launches read off the
   encoders phase's dpn68, and each direction's device time at the stem
   beside its bound and ``F.batch_norm``'s); K4 and K4b on
   their column design at the W = 1 heads of TDNN and ECAPA and a masked
   1000-frame extraction bucket (POOL_W1_SHAPES: reruns bit for bit,
   ``torch.var_mean`` and its autograd beside them; rows
   ``stats_pool:column`` and ``stats_pool_bwd:column``, their launches read
   off the encoders phase); K9 / K9b (the stride-1 split chain in
   training) at the bench step's four stride-1 stage shapes and
   res2net200_att's four (SPLIT_TRAIN_SHAPES): bf16 and float32 against the
   plain version
   in float64 on each run's own relu decisions, launch counts a call,
   reruns bit for bit, device time forward and backward beside the bound,
   the plain version and today's route (cuDNN conv + K5 + adds + cat);
   K5's head design (the 2-D calls) at the bench step's pre_bn and post_bn,
   dpn68's pre_bn and TDNN's (HEAD_BN_SHAPES), bf16 and float32, one launch
   a direction, reruns bit for bit, each direction's device time beside its
   bound, the plain version's and ``F.batch_norm``'s (row ``bn_train:head``,
   its launches read off the train phase); K10 (the stride-2 split stage in
   eval) at every stride-2 stage of a B=128 x 1000-frame forward of the
   serving model and of the bench model (res2net50_w8_s6_c16, the one the
   export phase embeds through): float32 and bf16 against the plain
   version, the average-pool channels bit-equal, each stage's device time
   beside the bound, the plain version, today's route (cuDNN grouped conv +
   K3 + avg_pool_3x3 + cat) and cuDNN's grouped conv alone; three launches
   a forward in the serve phase, none in any training step; K11 / K11b (the
   stride-2 split stage in training) at the bench step's three stride-2
   shapes and res2net200_att's (STRIDE2_TRAIN_SHAPES), bf16 and float32
   against the plain version in float64 on each run's own relu decisions,
   the tail bit-equal to the plain version's, launch counts a call, reruns
   bit for bit, device time forward and backward beside the bound, the
   plain version, today's route (cuDNN grouped conv + K5 + pool + cat,
   through autograd) and cuDNN's grouped conv alone (forward; dgrad +
   wgrad); four launches a stride-2 stage a microbatch in every Res2Net
   training phase (the forward's two again in a rematerialized stage), none
   of the route but in the launch phase's spanning run.
   ``ms`` is a call's time by CUDA events, host included; ``device_ms``
   (K1, K4, K4b, K6, K7 and K4's library yardsticks)
   the kernel's own time by torch.profiler, the time of record for calls
   under ~0.3 ms;
4. serve   -- res2net50_w24_s4_c32 at full width, bf16, random weights from
   a seed, served over TCP by ``cli.serve.make_server``; feature, wave and
   score requests from four client threads; served embeddings checked
   against offline extraction, wave against feature requests, and a small
   batch against the CPU plain path; every kernel's launch count must rise;
5. train   -- ``training.loop.fit`` with the CLI's synthetic feeder on
   res2net50_w8_s6_c16 at the bench shape (B=256 x A=4, 200 frames, 80-d,
   bn_groups=8, bf16, 5994 classes): one warm-up and three timed steps;
   finite loss, schedule-exact lr and margin, and launch counts of K4, K4b,
   K5, K6 and K9 / K9b equal to A x their per-microbatch counts (every
   stride-1 chain on K9 / K9b: none through F.conv2d; K5's 2-D calls on its
   head design, 8 + 8 a step, and none on the multi-kernel design, here and
   in the raw, lmft, encoders and single_chip phases); then resident steps
   with TF32 off and on in turns (the bf16 step's time either way);
6. train_parity -- one float32 step (TF32 off) of the full-width model at
   B=16, A=1, bn_groups=2 on the card and through the plain path on the CPU
   from the same weights: loss, gradient norm, parameter update and BN
   statistics within the stated tolerances;
7. raw     -- raw-audio training (slice 9) through ``cli.train.main --raw``
   at the train phase's shape (res2net50_w8_s6_c16, B=256 x A=4, 200
   frames, context 150, dither 1.0, bn_groups 8, bf16, 5994 classes): a
   wav.scp of 600 synthetic utterances of 1-12 s (a quarter JSON reverb +
   noise specs over synthetic RIR and noise wavs) and utt2id.pkl written
   at run time, the native raw feeder, one warm-up and two timed steps;
   finite loss, schedule-exact lr and margin, no decode errors or dead
   workers, K1's dithered variant and K7 A launches a step, K4-K6 as in
   phase 5; the feeder's own rate with no step behind it (6 threads); on
   one microbatch (of a one-thread feeder: a function of the seed) and a
   fixed draw, the front end and K1 dithered on the card against their
   plain versions and float64 (see TOL_FBANK), bit-equal on a rerun, and
   K1 with framed per-sample draws bit-equal to K1 on the dithered wave;
   each front-end part's device time; one resident step under
   torch.profiler;
8. lmft    -- the LMFT leg (``res2net_finetune_vox2_dev``, 600-frame crops,
   margin 0.4) at bench.py's shape (B=256 x A=4, bn_groups=16, stages 0-2
   rematerialized) through ``cli.train.main``: a CM-compressed Kaldi
   feature store written by the port's kaldi_io, the native C++ feeder,
   and a resume from phase 5's trained state saved as the last checkpoint
   of the pretrain experiment dir; one warm-up and two timed steps with
   finite loss, schedule-exact lr and margin, no decode errors and launch
   counts of K4, K4b, K5 (its forward again inside the recomputed blocks)
   and K6 as expected; and, from one state and one B=64 f600 batch, a
   rematerialized and a plain step: BN statistics bit-equal, loss and
   gradient norm within TOL_PARITY, lower peak memory with remat;
9. export  -- the trained state saved as an inference artifact and one batch
   embedded through the eval path (K2-K4, K10), against the CPU plain path;
10. evaluate -- the recipe's last leg on the LMFT run of phase 8, through the
   CLIs a user calls: a test set shaped like VoxCeleb1-O (synthetic 16 kHz
   wavs, EVAL_* below; its full 37,720 trials) featurized on the card by
   ``data/features.py`` (K1) into a plain store; a CM-compressed cohort
   store of 600 utterances; ``cli.export`` of the LMFT exp dir;
   ``cli.extract`` of the test set with host and with device CMVN (K7) in
   turns; ``cli.evaluate`` twice into one out dir (the cohort set's speaker
   means, then the 11,988 projection rows, reusing the xvectors);
   ``cli.score`` cosine and asnorm (top-400), its printed EER and minDCF
   against eval/metrics of its scores file, and the cohort statistics on
   the card against float64, and their time and bound; a 256-utterance
   subset (one wav.scp entry a JSON augmentation spec) from its own store,
   on the bf16 wire and with ``--raw`` (K1); 16 utterances through the
   float32 plain path on the CPU, and the same float32 artifact on the card
   with TF32 off (``cli.extract``) and on, as cosines against the CPU's.
   ``cli.evaluate`` and the subset's extractions run the default CMVN,
   which is K7's. Each leg's launches are read from counts set to 0 just
   before it;
11. encoders -- the remaining encoder families at full width,
   each through ``cli.train.main --synthetic`` with its recipe
   (ENCODER_RUNS: res2net200_w24_s4_c32_att, dpn68, tdnn, ecapa_tdnn_512
   with --specaug; effective batch 1024): finite loss, schedule-exact lr
   and margin, launch counts of K4/K4b, K5, K6 and K8/K8b per microbatch;
   step ms, trained audio-s/s and peak memory; then each exported artifact
   extracts one 1000-frame bucket batch of mixed lengths in bf16 through
   eval/extract.py (ms, audio-s/s, K8 once a forward for the attentive
   families, padded vs exact-length rows, rows against the CPU float32
   plain path); then a float32 step of a thin variant of each family on
   the card against the CPU (TOL_PARITY), and the thin ECAPA's at 16 rows
   printed (THIN_PARITY_PRINTED_BATCH);
12. single_chip -- ``cli.train.main --single-chip`` with res2net200_w24_s4_c32_att
   and its recipe (which runs out of memory at the recipe's microbatch): the
   shape must be recipes.SINGLE_CHIP_SHAPES's; its peak memory and step ms;
13. launch -- ``cli.launch --num-processes 2`` on the one card (gloo: the
   processes share it), res2net50_w8_s6_c16 at full width, float32, B=32 x
   A=2, one step, the synthetic rows of one source: data 2 at bn_groups 1
   (every group spans both ranks: K5's spanning mode, and the split
   stages' span routes, no K9 / K11) and model 2 (the head's classes split:
   K6's class-sharded mode); each run's metrics.jsonl
   (``load_metrics``) and checkpoint against ``cli.train`` in one process on
   the same rows (loss and BN statistics within TOL_PARITY; the update and
   the gradient norm within twice the one-process step's own float32 noise
   plus TOL_PARITY, as in phase 6); each rank's launches of the spanning
   and class-sharded kernels; a data-2 run at bn_groups 2 (every group
   inside a rank: K9 and K11 on each rank with groups / ranks, no spanning
   kernel); then a one-rank launch, which takes NCCL;
14. trace -- two bench-shape steps under ``utils.observability.trace``: the
   Chrome trace under ``<exp>/profile`` must name K5's and K6's kernels;
15. prepare -- ``cli.prepare_data.main`` stages 2, 4 and 5 on the card over
   corpora written at run time (PREP_*): a wav tree of 128 utterances of
   3-8 s over 16 speakers, a MUSAN tree (noise, annotated music with one
   vocal track, speech) and ``simulated_rirs/{smallroom,mediumroom}`` with
   ``rir_list`` metadata and RIRs of 200-400 samples; both data dirs
   validate clean, K1 launches once a batch of each featurization (counted
   against the buckets of the utterances' lengths), and on a subset of the
   ``_aug`` dir K1 on the rendered waves is held as the raw phase holds it
   (plain version and float64) and the CM store equals K1's features within
   CM's step; stage 4's and 5's audio-s/s;
16. import -- the reference checkpoint import at full width: a TF bundle of
   res2net50_w24_s4_c32 with the sc_cm_linear 5994 x 2 head, every
   ``/Momentum`` slot and ``global_step`` (scripts/tf_bundle_writer.py, from
   ``init_weights`` through the inverse of the ported name map), read back
   by ``utils/tf_bundle.py`` (its host MB/s), then ``cli.import_checkpoint``
   -> ``cli.export`` -> ``cli.extract`` on the prepare phase's store: the
   artifact's weights equal the original ones and its embeddings those of
   an artifact saved from them (TOL_EXTRACT_COS); one resumed
   ``cli.train`` step whose step is global_step + 1 and whose momentum
   continues the slots (|m' - 0.9 m| within the clip norm);
17. multi_device -- extraction over [cuda:0, cuda:0] (two replicas, each
   bucket batch split in two) bit-equal to one device at the half batch and
   to its own rerun, within TOL_EXTRACT_COS of one device at the whole
   batch; ``cli.extract --num-devices`` beyond the cards present fails with
   its error.

The kernels phase also holds the multi-process kernel modes: K1's general path
(32 kHz, and a 64 ms frame at 16 kHz, dithered and not, and a batch of 8
waves) against its plain version and float64, one CUDA kernel a call;
K5's spanning mode on two halves of (256, 96, 200, 80) and on two ranks of
a real spanning shape (SPAN_REAL: 16 of 16 ranks' rows at bn_groups 8)
against whole-batch K5, reruns bit for bit, two CUDA kernels a direction
(the profiler), a rank's device time beside the bound, with an NCCL
all-reduce of its sums timed (world size 1); K6's class-sharded mode on two
class ranges of (2, 256, 5994) against whole K6.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that line. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
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
# (float32 and float64 on the CUDA cores, bfloat16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}
# stated tolerances: fp32 kernel vs fp32 plain (relative to the output's
# largest magnitude), bf16 kernel vs fp32 plain on the same bf16 inputs
TOL_FBANK = 1e-3          # absolute, log-mel
# the raw phase's speech-like crops have quiet low mel bands, where any
# float32 analysis cancels: over 8 microbatches K1 strayed up to 5.9e-3
# log-mel from a float64 run there and its plain version up to 8.6e-3,
# either one the worse (scripts/k1_accuracy.py, PERF.md §6). On those
# crops (one batch of a one-thread feeder: a function of the seed) K1 and
# the front end are held against float64, within twice the plain version's
# own distance to it or TOL_FBANK where that is larger; on white-noise
# crops of the same lengths against the plain version within TOL_FBANK;
# and K1's draws exactly (check_fbank_dither)
TOL_FP32 = 1e-4
TOL_BF16 = {"split_conv": 5e-2, "bn_act": 2e-2, "stats_pool": 1e-2}
TOL_SERVED_COS = 0.9999   # served vs offline / wave vs feature embeddings
TOL_CPU_COS = 0.99        # bf16 GPU forward vs fp32 CPU plain forward
# training step (slice 2): the bench shape, and the stated tolerances
TRAIN_MODEL, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_FRAMES, TRAIN_GROUPS = (
    "res2net50_w8_s6_c16", 256, 4, 200, 8)
TRAIN_STEPS = 4           # one warm-up + three timed
# the LMFT leg (bench.py:224-233): f600, B=256 x A=4, bn_groups=16, stages
# 0-2 rematerialized; the feature store it reads, and the B=64 comparison
LMFT_FRAMES, LMFT_GROUPS, LMFT_STAGES, LMFT_STEPS = 600, 16, (0, 1, 2), 3
LMFT_UTTS, LMFT_SHARDS, LMFT_LENGTHS = 512, 4, (600, 1201)
LMFT_CHECK_BATCH, LMFT_CHECK_GROUPS = 64, 4
# the raw-audio leg (slice 9): the bench shape from a wav.scp through the
# native raw feeder (RAW_WORKERS threads), K1 dithered and K7 in the step;
# one warm-up and two timed steps; the data: RAW_UTTS utterances of
# RAW_SECONDS from RAW_BANKS synthetic speakers, every RAW_SPEC_EVERY-th a
# reverb + noise spec; the feeder alone times RAW_FEEDER_BATCHES batches
RAW_STEPS, RAW_WORKERS, RAW_FEEDER_BATCHES = 3, 6, 3
RAW_UTTS, RAW_SECONDS, RAW_BANKS, RAW_SPEC_EVERY = 600, (1.0, 12.0), 40, 4
# K6 on both training paths: one launch a direction on the slab path, none
# on the streaming path (the 5994-class head fits the slab)
K6_SLAB_PER_MICROBATCH = {"margin_ce.margin_ce_fwd:slab": 1, "margin_ce.margin_ce_bwd:slab": 1,
                          "margin_ce.margin_ce_fwd:stream": 0,
                          "margin_ce.margin_ce_bwd:stream": 0}
# K4b/K5/K6 vs autograd of the plain version: fp32 relative to the output's
# largest magnitude; K5 bf16 against the plain version run in bf16; K5's
# input gradients where both versions take the same relu decision, in fp32
# within 1e-3: an element whose relu decision differs still moves its
# group's sums by |dy| / n, ~1e-4 of max |dx| per element at n = 8000
TOL_TRAIN_BF16 = 2e-2
TOL_K5_GRAD_FP32 = 1e-3
# fp32 GPU step vs fp32 CPU plain step (B=16, A=1, bn_groups=2): relative
# errors of the loss and of the BN statistics (each buffer relative to
# max(|v|, 1e-3): the head post-BN's running mean is rounding noise with no
# scale of its own). The parameter update (L2 over all parameters) and the
# gradient norm of a randomly initialized net at this batch are fp32-noisy
# on either device (the update ~2% from a float64 step): the card's fp32
# values must be no further from the CPU's float64 step than twice the CPU's
# fp32 values are, plus 1e-3; their distance to the CPU fp32 step is reported
TOL_PARITY = {"loss": 1e-4, "gradient_norm": 1e-3, "update": 1e-3, "batch_stats": 1e-3}
# K7 (sliding CMVN) at cli/extract.py's buckets and one longer utterance,
# against float64 (absolute, on features of 12 +- 3)
CMVN_BATCH, CMVN_BUCKETS, CMVN_LONG = 8, (500, 1000, 2000, 4000, 8000, 16000), 60000
CMVN_PAST_N = 8001  # a row of the largest bucket: its tile at 15,000 reads rows 7,701-8,000
CMVN_FLAGS = [dict(), dict(center=False), dict(norm_vars=True), dict(center=False, norm_vars=True)]
TOL_CMVN = 1e-5
# the evaluation leg: a test set shaped like VoxCeleb1-O (whose test
# side has 4,874 utterances of 40 speakers and 37,720 trials, half targets),
# cut to EVAL_SPEAKERS x EVAL_UTTS synthetic utterances of 4-20 s plus one of
# 60-145 s for each of the first EVAL_LONG speakers; the full trial count; a
# cohort set of COHORT_SPEAKERS x COHORT_UTTS feature matrices; and the
# trained head's 2 x 5994 projection rows. Subsets: EVAL_SUBSET utterances
# for the device-CMVN, bf16-wire and raw-audio extractions, EVAL_CPU_UTTS
# for the CPU plain path.
EVAL_SPEAKERS, EVAL_UTTS, EVAL_SECONDS, EVAL_LONG, EVAL_LONG_SECONDS = (
    40, 30, (4.0, 20.0), 4, (60.0, 145.0))
VOX1_O_UTTS, EVAL_TRIALS, EVAL_TOPK = 4874, 37720, 400
COHORT_SPEAKERS, COHORT_UTTS, COHORT_FRAMES = 200, 3, (300, 1200)
EVAL_SUBSET, EVAL_CPU_UTTS = 256, 16
TOL_EXTRACT_COS = 0.9999  # host vs device CMVN, bf16 vs float32 wire, raw vs store
TOL_COHORT_STATS = 1e-5   # asnorm top-k mean / std on the card vs float64 numpy
# the remaining encoders, each at full width through
# cli.train.main --synthetic with its family's recipe: (model, recipe,
# microbatch, accumulation steps, rematerialized stages, extra CLI flags).
# The recipes' effective batch is 1024 rows (256 x 4; TDNN's 1024 x 1);
# where the card does not hold the recipe's microbatch, a smaller one with
# more accumulation keeps B x A = 1024. ENCODER_STEPS steps: one warm-up and
# the rest timed. Extraction: one bucket batch (eval/extract.py's
# default_batch_size) of ENCODER_EXTRACT_LENGTHS frames into the 1000-frame
# bucket; its first rows' lengths are multiples of 8 (DPN's strided SAME
# convs anchor outputs by the parity of T, in both packages, so only such
# rows equal their exact-length forward); ENCODER_CPU_FRAMES-frame rows
# against the float32 plain path on the CPU.
ENCODER_RUNS = (
    # the recipe's 256 rows run out of memory (84.1 GB); 128 without remat
    # peaks at 70.5 GB in a fresh process, 22.1 GB with stages 1-2
    # rematerialized (scripts/encoder_memory.py, NVIDIA H100 80GB HBM3)
    ("res2net200_w24_s4_c32_att", "res2net_vox2_dev_aug", 128, 8, (1, 2), ()),
    ("dpn68", "dpn_vox2_dev_aug", 256, 4, None, ()),
    ("tdnn", "tdnn_voxsrc2020_vox2_dev_aug", 1024, 1, None, ()),
    ("ecapa_tdnn_512", "ecapa_vox2_dev_aug", 256, 4, None, ("--specaug",)),
)
ENCODER_STEPS = 3
# the thin variants' float32 card-vs-CPU step: 64 rows, 32 a BN group. At
# 16 rows (8 a group) the thin ECAPA's step on an H100 strays 1.70e-3 from the
# float64 step where the CPU's strays 5.3e-5: every module of the step on the
# card is as close to float64 as on the CPU, but the sc_cm_linear head's max
# over its two sub-centers takes the other center at two (row, class) pairs
# whose float64 cosines lie within 1e-5 (the CPU takes none), a discrete
# choice of the reference's own (PERF.md §6, scripts/parity_attribution.py
# --modules --flips). That 16-row step is printed, not held
THIN_PARITY_BATCH, THIN_PARITY_PRINTED_BATCH = 64, 16
ENCODER_EXTRACT_LENGTHS, ENCODER_EXACT_LENGTHS, ENCODER_CPU_FRAMES = (520, 1000), (1000, 808, 600, 520), 300


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


def device_ms(fn, name=None, reps: int = 20) -> float:
    """Device milliseconds of one call of ``fn``: torch.profiler (CUPTI) over
    ``reps`` calls after a warm-up, the device kernels whose name holds
    ``name`` (every device activity if None), divided by ``reps``. The time
    of record for calls under ~0.3 ms, where ``time_ms`` measures the host.
    Where the profiler reports no device time twice (it once dropped a
    window on the card), the calls are timed back to back by CUDA events
    instead, and a ``device_ms`` line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA" and not e.key.startswith("Command Buffer")
                 and (name is None or any(n in e.key for n in (
                     (name,) if isinstance(name, str) else name))))
        if us > 0:
            return us / reps / 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    emit({"phase": "device_ms", "call": str(name or "library call"), "source": "cuda_events",
          "note": "the profiler reported no device time"})
    return a.elapsed_time(b) / reps


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
    split stage as (width, T, F), K3 as (C, T, F, relu, shortcut mode,
    mask), and K10 per stride-2 split stage as (width, T, F) of its input,
    with their multiplicities."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import _strided

    t, f = FRAMES, FEAT_DIM
    k2, k3, k10 = {}, {}, {}

    def add(d, key):
        d[key] = d.get(key, 0) + 1

    add(k3, (cfg.num_filters[0], t, f, True, 0, True))
    for i, n in enumerate(cfg.block_sizes):
        w, s, out_c = cfg.width[i], cfg.block_strides[i], cfg.num_filters[i] * 4
        for j in range(n):
            stride = s if j == 0 else 1
            add(k3, (cfg.split * w, t, f, True, 0, True))           # bn1
            t2, f2 = _strided(t, stride), _strided(f, stride)
            add(k2 if stride == 1 else k10, (w, t, f))
            add(k3, (out_c, t2, f2, True, 2 if j == 0 else 1, True))  # bn3 + shortcut
            t, f = t2, f2
    return k2, k3, k10, (cfg.num_filters[-1] * 4, t, f)


SPLIT_FUNCTIONS = {"fused": "split_chain_fused", "pipe": "split_group_pipe",
                   "wgmma": "split_group_wgmma", "mma": "split_group_mma", "fma": "split_group"}


def split_launches_by_function(k2_calls, split) -> dict:
    """K2's launches per bf16 forward by C entry point (the variant its plan
    names): one per fused chain, else one per group."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import split_plan

    out = {f"split_conv.{fn}": 0 for fn in SPLIT_FUNCTIONS.values()}
    for (w, t, f), n in k2_calls.items():
        variant = split_plan(w, t, f, torch.bfloat16, split)["variant"]
        out[f"split_conv.{SPLIT_FUNCTIONS[variant]}"] += n * (1 if variant == "fused" else split - 1)
    return out


# the eval-only kernels: no training step may launch them
# K4 and K4b once a microbatch, on their ring design (heads of <= 128 frames:
# the Res2Net and DPN heads)
POOL_RING_PER_MICROBATCH = {"stats_pool.stats_pool:ring": 1,
                            "stats_pool_bwd.stats_pool_bwd:ring": 1}
K10_FNS = tuple(f"split_stride2.split_stride2:{d}" for d in ("mma", "vec", "single"))
EVAL_KERNEL_FNS = tuple(f"split_conv.{fn}" for fn in SPLIT_FUNCTIONS.values()) + tuple(
    f"bn_act.bn_act:{path}" for path in ("vec", "fold", "single")) + K10_FNS


def split_launches(k2_calls, split) -> int:
    """K2's launches per forward: one per fused chain, else one per group."""
    return sum(split_launches_by_function(k2_calls, split).values())


# ----------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------

def check_fbank(dev, gen):
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    cfg = fb.FbankConfig(num_bins=FEAT_DIM, dither=0.0)
    err, rerun_equal = 0.0, True
    rng = np.random.RandomState(SEED)
    # 8 wave requests of 2-8 s, one each of 2 s, 8 s and 128 s (the longest
    # serving takes), and a batch of 3; each run twice (bit for bit)
    shapes = [(1, int(rng.randint(2 * 16000, 8 * 16000 + 1))) for _ in range(8)]
    shapes += [(1, 2 * 16000), (1, 8 * 16000), (1, 128 * 16000), (3, 5 * 16000 + 123)]
    for batch, n in shapes:
        wave = torch.from_numpy(fb.pcm16(rng.randn(batch, n) * 3000).astype(np.float32)).to(dev)
        got, want = fb.fbank(wave, cfg), fb.fbank_reference(wave, cfg)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"fbank: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        err = max(err, abs_err(got, want))
        rerun_equal &= torch.equal(got, fb.fbank(wave, cfg))
    if err > TOL_FBANK or not rerun_equal:
        fail(f"fbank: max |kernel - plain| {err} > {TOL_FBANK} or reruns differ ({rerun_equal})")
    # timing at one 8 s wave request
    wave = torch.from_numpy(fb.pcm16(rng.randn(8 * 16000) * 3000).astype(np.float32)).to(dev)[None]
    t = fb.num_frames(wave.shape[1], cfg)
    a, _, _ = fb.analysis_matrices(cfg)
    flops = 2 * t * a.shape[0] * a.shape[1] * 2 + 2 * t * a.shape[1] * FEAT_DIM
    nbytes = 4 * (wave.numel() + 2 * a.size + a.shape[1] * FEAT_DIM + t * FEAT_DIM)
    bms, by = bound_ms(nbytes, flops, torch.float32)
    ms = time_ms(lambda: fb.fbank(wave, cfg), reps=20)
    dev_ms = device_ms(lambda: fb.fbank(wave, cfg), "fbank_kernel")
    plain = time_ms(lambda: fb.fbank_reference(wave, cfg), reps=20)
    plain_dev = device_ms(lambda: fb.fbank_reference(wave, cfg))
    by_length = {}
    for sec in (2, 128):
        w = torch.from_numpy(fb.pcm16(rng.randn(1, sec * 16000) * 3000).astype(np.float32)).to(dev)
        by_length[f"{sec}s"] = device_ms(lambda: fb.fbank(w, cfg), "fbank_kernel")
    # 160 mel bins: more than one launch's 128 columns, so two passes; an 8 s
    # wave and a batch of 3
    cfg160 = fb.FbankConfig(num_bins=160, dither=0.0)
    err160 = 0.0
    for batch, n in ((1, 8 * 16000), (3, 5 * 16000 + 123)):
        w = torch.from_numpy(fb.pcm16(rng.randn(batch, n) * 3000).astype(np.float32)).to(dev)
        got, want = fb.fbank(w, cfg160), fb.fbank_reference(w, cfg160)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"fbank 160 bins: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        err160 = max(err160, abs_err(got, want))
    if err160 > TOL_FBANK:
        fail(f"fbank 160 bins: max |kernel - plain| {err160} > {TOL_FBANK}")
    bms160, by160 = bound_ms(nbytes + 4 * a.shape[1] * 80 + 4 * t * 80,
                             flops + 2 * t * a.shape[1] * 80, torch.float32)
    bins160 = dict(max_abs_err=err160, per="one 8 s wave request",
                   ms=time_ms(lambda: fb.fbank(wave, cfg160), reps=20),
                   device_ms=device_ms(lambda: fb.fbank(wave, cfg160), "fbank_kernel"),
                   plain_ms=time_ms(lambda: fb.fbank_reference(wave, cfg160), reps=20),
                   plain_device_ms=device_ms(lambda: fb.fbank_reference(wave, cfg160)),
                   bound_ms=bms160, bound_by=by160,
                   note="two passes of at most 128 mel columns, each recomputing the "
                        "power spectrum")
    return dict(name="fbank", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/fbank.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/pallas/fbank.py:85 "
                         "(fbank_fused, retired in 912d3e9; = ops/fbank.py:191 fbank)",
                max_abs_err=err, tolerance=TOL_FBANK, dtype="float32",
                per="one 8 s wave request", ms=ms, device_ms=dev_ms, plain_ms=plain,
                plain_device_ms=plain_dev, device_ms_by_length=by_length,
                checked_shapes=shapes, reruns_bit_equal=rerun_equal, mel_bins_160=bins160,
                launch_plan=fb.kernel_plan(cfg, dev), bound_ms=bms,
                bound_by=by, library_ms=None,
                library_note="none: no single PyTorch call computes Kaldi FBANK "
                             "(the card has no torchaudio)")


def check_split(dev, gen, k2_calls, split):
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    import torch.nn.functional as F

    err32, err16, detail = 0.0, 0.0, []
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
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
        # the kernels' own device time, and the call's (with the wrapper's
        # weight layout copy)
        dev_ms = device_ms(lambda: rn.split_chain(xb, wb, means, var, mask), "split_")
        dev_call = device_ms(lambda: rn.split_chain(xb, wb, means, var, mask))
        plain = time_ms(lambda: rn.split_chain_reference(xb, wb, means, var, mask))
        # library yardstick, conv only: cuDNN's 3x3 conv of each group with the
        # eval BN folded into its weight and bias (no masked add, no relu)
        xg = xb[:, :w].contiguous(memory_format=torch.channels_last)
        lib = 0.0
        for i in range(split - 1):
            rstd = torch.rsqrt(var[i] + 1e-5)
            wf = (weight[i * w: (i + 1) * w] * rstd[:, None, None, None]).bfloat16().contiguous(
                memory_format=torch.channels_last)
            bias = (-means[i] * rstd).bfloat16()
            lib += time_ms(lambda: F.conv2d(xg, wf, bias, padding=1))
        detail.append(dict(width=w, T=t, F=f, calls_per_forward=count, err_fp32=e32,
                           err_bf16=e16, plan=rn.split_plan(w, t, f, torch.bfloat16, split),
                           ms_bf16=ms, device_ms=dev_ms, device_ms_call=dev_call,
                           plain_ms_bf16=plain, library_ms_conv_only=lib,
                           bound_ms=bms, bound_by=by))
        err32, err16 = max(err32, e32), max(err16, e16)
        tot["ms"] += count * ms
        tot["device_ms"] += count * dev_ms
        tot["plain_ms"] += count * plain
        tot["library_ms"] += count * lib
        tot["bound_ms"] += count * bms
        by_ops += count * bms if by == "operations" else 0.0
        del xb, xg
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
                library_call="F.conv2d (cuDNN) per group, eval BN folded into weight and "
                             "bias, conv only",
                bound_by="operations" if by_ops * 2 > tot["bound_ms"] else "bytes")


def stride2_route(x, weight, means, var):
    """The route K10 replaced, on the card (its library yardstick): the
    padded copy, cuDNN's grouped conv at stride 2, K3 over the s-1 groups,
    the nine strided adds of the average pool, the concat."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops
    import torch.nn.functional as F

    s = len(means) + 1
    w = x.shape[1] // s
    xp = ops.fixed_padding(x, 3)
    y = F.conv2d(xp[:, : w * (s - 1)], weight, stride=2,
                 groups=s - 1).contiguous(memory_format=torch.channels_last)
    y = ops.bn_act(y, torch.cat(means), torch.cat(var), relu=True)
    return torch.cat([y, ops.avg_pool_3x3(xp[:, w * (s - 1):], 2)],
                     dim=1).contiguous(memory_format=torch.channels_last)


def check_split_stride2(dev, gen, k10_calls):
    """K10 at every stride-2 stage of a B x FRAMES forward of each model in
    ``k10_calls`` ({model: (split, {(w, T, F): calls})}; the first is the
    serving model, whose forward the row's totals are): float32 and bf16
    against the plain version (float32, on the same inputs), the
    average-pool channels bit-equal to the plain version in the kernel's
    dtype, reruns bit for bit; bf16 ms (events), device ms (profiler: K10's
    kernel, and every device kernel of the call), the plain version's ms,
    today's route (cuDNN grouped conv + K3 + avg_pool_3x3 + cat) and cuDNN's
    grouped conv alone on the padded input, the bytes bound and the device
    ms's share of it."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops
    import torch.nn.functional as F

    err32, err16, tails, reruns, detail = 0.0, 0.0, True, True, []
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "library_route_ms": 0.0, "library_route_device_ms": 0.0, "bound_ms": 0.0}
    serving = next(iter(k10_calls))
    for model, (split, calls) in k10_calls.items():
        for (w, t, f), count in sorted(calls.items()):
            c, tail = split * w, slice((split - 1) * w, None)
            mask = lengths_mask(gen, BATCH, t, dev)
            x = torch.randn((BATCH, c, t, f), generator=gen, device=dev)
            x = (x * mask[:, None, :, None]).contiguous(memory_format=torch.channels_last)
            weight = torch.randn((w * (split - 1), w, 3, 3), generator=gen, device=dev) / math.sqrt(9 * w)
            means = [0.1 * torch.randn(w, generator=gen, device=dev) for _ in range(split - 1)]
            var = [0.5 + 1.5 * torch.rand(w, generator=gen, device=dev) for _ in range(split - 1)]
            got = rn.split_stride2(x, weight, means, var)
            want = rn.split_stride2_reference(x, weight, means, var)
            e32, t32 = rel_err(got, want), torch.equal(got[:, tail], want[:, tail])
            del got, want
            xb, wb = x.bfloat16(), weight.bfloat16()
            del x
            gotb = rn.split_stride2(xb, wb, means, var)
            e16 = rel_err(gotb, rn.split_stride2_reference(xb.float(), wb.float(), means, var))
            t16 = torch.equal(gotb[:, tail], rn.split_stride2_reference(xb, wb, means, var)[:, tail])
            rerun = torch.equal(gotb, rn.split_stride2(xb, wb, means, var))
            del gotb
            t2, f2 = (t - 1) // 2 + 1, (f - 1) // 2 + 1
            flops = (split - 1) * 2 * BATCH * t2 * f2 * 9 * w * w
            nbytes = 2 * BATCH * c * (t * f + t2 * f2) + 2 * wb.numel() + 8 * (split - 1) * w
            bms, by = bound_ms(nbytes, flops, torch.bfloat16)
            k10 = lambda: rn.split_stride2(xb, wb, means, var)  # noqa: E731
            route = lambda: stride2_route(xb, wb, means, var)  # noqa: E731
            xp = ops.fixed_padding(xb, 3)[:, : w * (split - 1)]
            conv = lambda: F.conv2d(xp, wb, stride=2, groups=split - 1)  # noqa: E731
            row = dict(model=model, width=w, split=split, T=t, F=f, calls_per_forward=count,
                       err_fp32=e32, err_bf16=e16, tail_bit_equal_fp32=t32,
                       tail_bit_equal_bf16=t16, rerun_bit_equal=rerun,
                       plan=rn.stride2_plan(w, split, tuple(xb.shape), torch.bfloat16),
                       ms=time_ms(k10), device_ms=device_ms(k10, "stride2"),
                       device_ms_call=device_ms(k10),
                       plain_ms=time_ms(lambda: rn.split_stride2_reference(xb, wb, means, var)),
                       library_route_ms=time_ms(route), library_route_device_ms=device_ms(route),
                       library_conv_ms=time_ms(conv), library_conv_device_ms=device_ms(conv),
                       bound_ms=bms, bound_by=by)
            row["bound_share"] = bms / row["device_ms"]
            detail.append(row)
            err32, err16 = max(err32, e32), max(err16, e16)
            tails &= t32 and t16
            reruns &= rerun
            if model == serving:
                for k in ("ms", "device_ms", "plain_ms", "library_route_ms",
                          "library_route_device_ms", "bound_ms"):
                    tot[k] += count * row[k]
                tot["library_ms"] += count * row["library_conv_device_ms"]
            del xb, xp
            torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "split_stride2", "shapes": detail})
    if err32 > TOL_FP32 or err16 > TOL_BF16["split_conv"] or not tails or not reruns:
        fail(f"split_stride2: rel err fp32 {err32} bf16 {err16}, tails bit-equal {tails}, "
             f"reruns bit-equal {reruns}")
    return dict(name="split_stride2", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/split_stride2.cu",
                replaces="voxsrc2020_speaker_verification_tpu/models/res2net.py:52-80 "
                         "(Res2NetSplitConv strides > 1 branch: fixed_padding, grouped_conv, "
                         "BN + relu, avg_pool_3x3, concat; XLA)",
                max_abs_err=err16, max_rel_err_fp32=err32, tolerance=TOL_BF16["split_conv"],
                tail_bit_equal=tails, dtype="bfloat16",
                per=f"B={BATCH} x {FRAMES}-frame forward of {serving}", **tot,
                library_call="cuDNN's grouped conv at stride 2 alone (F.conv2d, groups=s-1, "
                             "on the padded input), device ms; library_route_*: the route K10 "
                             "replaced (F.pad + grouped conv + K3 + avg_pool_3x3 + cat)",
                bound_by="bytes")


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
        got16 = ops.bn_act(xb, mean, var, **kwb)
        e16 = rel_err(got16, ops.bn_act_reference(xb.float(), mean, var, **kwf))
        if not torch.equal(got16, ops.bn_act(xb, mean, var, **kwb)):
            fail(f"bn_act: two runs at {(c, t, f, relu, sc_mode, masked)} differ")
        del got16
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
                bound_by="bytes", library_ms=None,
                library_note="none for the fused epilogues; F.batch_norm (eval) computes the "
                             "flag-free pass alone: its time is in the bn_act phase line")


def var_mean_call(x, backward: bool):
    """The library yardstick of K4 (forward) and K4b (autograd backward): one
    ``torch.var_mean`` over T, the pooled axis (no mask)."""
    if not backward:
        return lambda: torch.var_mean(x, dim=2, keepdim=True, correction=0)
    xi = x.detach().requires_grad_(True)
    v, m = torch.var_mean(xi, dim=2, keepdim=True, correction=0)
    dv, dm = torch.randn_like(v), torch.randn_like(m)
    return lambda: torch.autograd.grad((v, m), [xi], (dv, dm), retain_graph=True)


def check_stats_pool(dev, gen, head_shape, train_head):
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    c, t, f = head_shape
    mask = lengths_mask(gen, BATCH, t, dev)
    x = torch.randn((BATCH, c, t, f), generator=gen, device=dev) * 3 + 1
    x = (x * mask[:, None, :, None]).contiguous(memory_format=torch.channels_last)
    e32 = rel_err(ops.stats_pool(x, mask), ops.stats_pool_reference(x, mask))
    xb = x.bfloat16()
    e16 = rel_err(ops.stats_pool(xb, mask), ops.stats_pool_reference(xb.float(), mask))
    again = ops.stats_pool(xb, mask)
    if not torch.equal(again, ops.stats_pool(xb, mask)):
        fail("stats_pool: two runs on the same inputs differ")
    nbytes = 2 * xb.numel() + 4 * BATCH * t + 2 * BATCH * 2 * c * f
    bms, by = bound_ms(nbytes, 3.0 * xb.numel(), torch.bfloat16)
    ms = time_ms(lambda: ops.stats_pool(xb, mask), reps=20)
    dev_ms = device_ms(lambda: ops.stats_pool(xb, mask), "stats_pool_kernel")
    plain = time_ms(lambda: ops.stats_pool_reference(xb, mask), reps=20)
    if e32 > TOL_FP32 or e16 > TOL_BF16["stats_pool"]:
        fail(f"stats_pool: rel err fp32 {e32} bf16 {e16}")
    # the library yardstick has no mask: both at the unmasked training shape
    c, t, f = train_head
    xt = _layout(torch.randn((TRAIN_BATCH, c, t, f), generator=gen, device=dev) * 2 + 1).bfloat16()
    e_train = rel_err(ops.stats_pool(xt), ops.stats_pool_reference(xt.float()))
    if e_train > TOL_BF16["stats_pool"]:
        fail(f"stats_pool: rel err bf16 {e_train} at the training shape")
    lib = var_mean_call(xt, backward=False)
    return dict(name="stats_pool", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/stats_pool.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:487 (stats_pool, XLA)",
                max_abs_err=e16, max_rel_err_fp32=e32, max_abs_err_train_shape=e_train,
                tolerance=TOL_BF16["stats_pool"],
                dtype="bfloat16", per=f"B={BATCH} head, (C, T, F)={head_shape}",
                ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=time_ms(lib, reps=20), library_device_ms=device_ms(lib),
                library_call="torch.var_mean over T, no mask",
                library_shape=[TRAIN_BATCH, c, t, f],
                library_vs_kernel_ms=time_ms(lambda: ops.stats_pool(xt), reps=20),
                library_vs_kernel_device_ms=device_ms(lambda: ops.stats_pool(xt),
                                                      "stats_pool_kernel"),
                library_shape_bound_ms=bound_ms(2 * xt.numel() + 2 * TRAIN_BATCH * 2 * c * f,
                                                3.0 * xt.numel(), torch.bfloat16)[0])


def train_shapes(cfg, batch, frames, feat_dim, stages=None):
    """The training forward's K5 calls per microbatch at batch x frames, as
    ((B, C, T, F) or (B, C), relu, shortcut mode) with multiplicities, and
    the stats pool's input (C, T, F). With ``stages``, only the calls inside
    the blocks of those stages (what a rematerialized stage runs again).
    The stride-1 chains' group BNs are K9's (``train_chains``), the stride-2
    stages' K11's (``train_stride2``)."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import _strided

    t, f = frames, feat_dim
    k5 = {}

    def add(key, counted=True):
        if counted:
            k5[key] = k5.get(key, 0) + 1

    add(((batch, cfg.num_filters[0], t, f), True, 0), stages is None)   # initial_bn
    for i, n in enumerate(cfg.block_sizes):
        w, s, out_c = cfg.width[i], cfg.block_strides[i], cfg.num_filters[i] * 4
        inside = stages is None or i in stages
        for j in range(n):
            stride = s if j == 0 else 1
            add(((batch, cfg.split * w, t, f), True, 0), inside)        # bn1
            t2, f2 = _strided(t, stride), _strided(f, stride)
            add(((batch, out_c, t2, f2), True, 2 if j == 0 else 1), inside)  # bn3 + shortcut
            t, f = t2, f2
    channels = cfg.num_filters[-1] * 4
    add(((batch, f * 2 * channels), False, 0), stages is None)          # head pre_bn
    add(((batch, cfg.output_dim), False, 0), stages is None)            # head post_bn
    return k5, (channels, t, f)


def train_chains(cfg, batch, frames, feat_dim, stages=None):
    """The training forward's stride-1 split chains per microbatch (K9 /
    K9b), as ((B, s*w, T, F), w, s) with multiplicities; with ``stages``,
    only those inside the blocks of those stages."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import _strided

    t, f = frames, feat_dim
    chains = {}
    for i, n in enumerate(cfg.block_sizes):
        w, s = cfg.width[i], cfg.block_strides[i]
        for j in range(n):
            stride = s if j == 0 else 1
            if stride == 1 and (stages is None or i in stages):
                key = ((batch, cfg.split * w, t, f), w, cfg.split)
                chains[key] = chains.get(key, 0) + 1
            t, f = _strided(t, stride), _strided(f, stride)
    return chains


def train_stride2(cfg, batch, frames, feat_dim, stages=None):
    """The training forward's stride-2 split stages per microbatch (K11 /
    K11b), as ((B, s*w, T, F), w, s) with multiplicities; with ``stages``,
    only those inside the blocks of those stages."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import _strided

    t, f = frames, feat_dim
    out = {}
    for i in range(len(cfg.block_sizes)):
        w, s = cfg.width[i], cfg.block_strides[i]
        if s == 2 and (stages is None or i in stages):
            key = ((batch, cfg.split * w, t, f), w, cfg.split)
            out[key] = out.get(key, 0) + 1
        t, f = _strided(t, s), _strided(f, s)
    return out


K11_FNS = tuple(f"split_stride2_train.split_stride2_train_{fn}"
                for fn in ("fwd", "finish", "bwd_stats", "bwd_grad"))


def k11_launches(stages, again=None) -> dict:
    """K11 / K11b's launches per microbatch for the stride-2 ``stages``
    (train_stride2, or {key: count}), and the forward again for the
    rematerialized ``again``: two a stage forward (the conv, the
    normalization), two backward (the BN sums, the gradients)."""
    n, m = sum((stages or {}).values()), sum((again or {}).values())
    return dict(zip(K11_FNS, (n + m, n + m, n, n)))


def k9_launches(chains, again=None) -> dict:
    """K9 / K9b's launches per microbatch for ``chains`` (train_chains), and
    the forward again for the rematerialized ``again``: s - 1 conv launches
    and one finishing launch a chain forward; backward, one statistics
    launch (group s-2's) and s - 1 grad launches, which fold the other
    groups' statistics in."""
    def conv(c):
        return sum((s - 1) * n for (_, _, s), n in (c or {}).items())

    def count(c):
        return sum((c or {}).values())

    return {"split_train.split_train_fwd": conv(chains) + conv(again),
            "split_train.split_train_finish": count(chains) + count(again),
            "split_train.split_train_bwd_stats": count(chains),
            "split_train.split_train_bwd_grad": conv(chains)}


def _layout(t):
    return t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t


def time_fwd_bwd(fn, inputs, dy):
    """(forward ms, backward ms) of ``fn(*inputs)`` and its gradient with
    respect to ``inputs`` for the cotangent ``dy``."""
    with torch.no_grad():
        fwd = time_ms(lambda: fn(*inputs))
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    bwd = time_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True))
    del y, leaves
    return fwd, bwd


def check_bn_train(dev, gen, k5_calls, groups):
    """K5 at each training call shape: fp32 and bf16 forward, running
    updates and backward against autograd of the plain version; bf16 times
    of the kernel and of the plain version, forward and backward."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops
    import torch.nn.functional as F

    err32, err32_grad, err16, detail, flips, reruns_equal = 0.0, 0.0, 0.0, [], 0, 0
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    by_ops = 0.0
    for (shape, relu, sc_mode), count in sorted(k5_calls.items()):
        c = shape[1]
        x = _layout(torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3)
        sc = _layout(torch.randn(shape, generator=gen, device=dev)) if sc_mode else None
        dy = _layout(torch.randn(shape, generator=gen, device=dev))
        rm, rv = 0.1 * torch.randn(c, generator=gen, device=dev), 0.5 + torch.rand(c, generator=gen, device=dev)

        def run(fn, x, sc, dy, stats):
            xi = x.detach().requires_grad_(True)
            si = None if sc is None else sc.detach().requires_grad_(True)
            kw = dict(groups=groups, relu=relu, shortcut=si)
            if sc_mode == 2:
                kw.update(shortcut_running_mean=stats[2], shortcut_running_var=stats[3])
            y = fn(xi, stats[0], stats[1], **kw)
            y.backward(dy)
            return [y.detach(), xi.grad] + ([si.grad] if si is not None else []) + list(stats)

        errs_by_dtype = {}
        for dtype in (torch.float32, torch.bfloat16):
            xs, ss, ds = x.to(dtype), None if sc is None else sc.to(dtype), dy.to(dtype)
            got = run(ops.bn_train, xs, ss, ds, [rm.clone(), rv.clone(), rm.clone(), rv.clone()])
            want = run(ops.bn_train_reference, xs, ss, ds,
                       [rm.clone(), rv.clone(), rm.clone(), rv.clone()])
            # gradients are compared where both versions take the same relu
            # decision: a pre-relu value within rounding of zero may fall on
            # either side, and one such element moves dx there by |dy| * rstd
            same = ((got[0] > 0) == (want[0] > 0)) if relu else torch.ones_like(got[0], dtype=torch.bool)
            flips = max(flips, int((~same).sum()))
            grads = slice(1, 3 if sc is not None else 2)
            parts = ([rel_err(a * same, b * same) for a, b in zip(got[grads], want[grads])]
                     + [rel_err(a, b) for a, b in zip(got[:1] + got[grads.stop:],
                                                      want[:1] + want[grads.stop:])])
            errs_by_dtype[str(dtype).split(".")[-1]] = parts  # dx, [ds,] y, stats
            ng = grads.stop - grads.start
            if dtype == torch.float32:
                err32 = max(err32, *parts[ng:])
                err32_grad = max(err32_grad, *parts[:ng])
            else:
                err16 = max(err16, *parts)
                # a rerun on the same inputs must agree bit for bit
                again = run(ops.bn_train, xs, ss, ds, [rm.clone(), rv.clone(), rm.clone(), rv.clone()])
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"bn_train: two runs at {shape} mode {sc_mode} differ")
                reruns_equal += 1
                del again
            del got, want, xs, ss, ds, same
        xb, sb, db = x.bfloat16(), None if sc is None else sc.bfloat16(), dy.bfloat16()
        del x, sc, dy
        stats = [rm.clone(), rv.clone(), rm.clone(), rv.clone()]

        def call(fn):
            def f(xi, *rest):
                kw = dict(groups=groups, relu=relu, shortcut=rest[0] if rest else None)
                if sc_mode == 2:
                    kw.update(shortcut_running_mean=stats[2], shortcut_running_var=stats[3])
                return fn(xi, stats[0], stats[1], **kw)
            return f

        inputs = [xb] + ([sb] if sb is not None else [])
        plan = ops.bn_train_plan(shape, groups, torch.bfloat16, sc_mode, relu)
        fwd, bwd = time_fwd_bwd(call(ops.bn_train), inputs, db)
        pfwd, pbwd = time_fwd_bwd(call(ops.bn_train_reference), inputs, db)
        n_in = 2 if sb is not None else 1
        # forward: read x (and s) once, write y; backward: read x, dy (and s,
        # or y for a raw shortcut under relu: the relu decision needs one of
        # them), write dx (and ds); ~8 and ~12 fp32 operations an element
        nbytes_f = 2 * xb.numel() * (n_in + 1)
        nbytes_b = 2 * xb.numel() * (2 + (1 if sc_mode == 2 or (sc_mode == 1 and relu) else 0)
                                     + (2 if sc_mode else 1))
        bms, by = bound_ms(nbytes_f + nbytes_b, 20.0 * xb.numel() * n_in, torch.float32)
        row = dict(shape=list(shape), relu=relu, shortcut_mode=sc_mode, calls_per_microbatch=count,
                   errors=errs_by_dtype, plan=plan,
                   ms_fwd_bf16=fwd, ms_bwd_bf16=bwd, plain_ms_fwd_bf16=pfwd, plain_ms_bwd_bf16=pbwd,
                   bound_ms=bms, bound_by=by)
        detail.append(row)
        tot["ms"] += count * (fwd + bwd)
        tot["plain_ms"] += count * (pfwd + pbwd)
        tot["bound_ms"] += count * bms
        by_ops += count * bms if by == "operations" else 0.0
        del xb, sb, db, inputs
        torch.cuda.empty_cache()
    # the flag-free g=1 pass is one PyTorch call: F.batch_norm in training mode
    shape = max((k[0] for k in k5_calls if len(k[0]) == 4), key=math.prod)
    c = shape[1]
    xb = _layout(torch.randn(shape, generator=gen, device=dev)).bfloat16()
    db = _layout(torch.randn(shape, generator=gen, device=dev)).bfloat16()
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    kfwd, kbwd = time_fwd_bwd(lambda x: ops.bn_train(x, rm, rv), [xb], db)
    lfwd, lbwd = time_fwd_bwd(
        lambda x: F.batch_norm(x, rm, rv, training=True, momentum=1 - ops.BN_MOMENTUM,
                               eps=ops.BN_EPSILON), [xb], db)
    library = dict(shape=list(shape), ms_fwd_bf16=kfwd, ms_bwd_bf16=kbwd,
                   library_ms_fwd_bf16=lfwd, library_ms_bwd_bf16=lbwd,
                   kernel_design=ops.bn_train_plan(shape, 1, torch.bfloat16, 0, False)["design"])
    del xb, db
    torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "bn_train", "shapes": detail, "library": library,
          "max_relu_flips_per_shape": flips, "reruns_bit_equal": reruns_equal})
    if err32 > TOL_FP32 or err32_grad > TOL_K5_GRAD_FP32 or err16 > TOL_TRAIN_BF16:
        fail(f"bn_train: rel err fp32 {err32} (gradients {err32_grad}) bf16 {err16}")
    return dict(name="bn_train", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/bn_train.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:117 "
                         "(_GroupedBN + relu/residual, XLA, forward and backward)",
                max_abs_err=err16, max_rel_err_fp32=err32, max_rel_err_fp32_grad=err32_grad,
                tolerance=TOL_TRAIN_BF16, max_relu_flips_per_shape=flips,
                reruns_bit_equal=reruns_equal,
                dtype="bfloat16", per=f"training step, B={TRAIN_BATCH} x A={TRAIN_ACCUM} x "
                f"{TRAIN_FRAMES} frames (forward + backward)",
                **{k: TRAIN_ACCUM * v for k, v in tot.items()},
                bound_by="operations" if by_ops * 2 > tot["bound_ms"] else "bytes",
                library_ms=lfwd + lbwd, library_vs_kernel_ms=kfwd + kbwd,
                library_shape=list(shape))


# K5's head design at the 2-D calls (bn_train_plan: "head", one launch a
# direction): the bench step's pre_bn and post_bn (res2net50_w8_s6_c16 at
# B = 256: 2 x 512 channels x 10 bins, and output_dim 192), dpn68's pre_bn
# and TDNN's (1024 rows), bn_groups 8, no relu or shortcut as in the heads;
# bf16 against the plain version run in bf16 (TOL_TRAIN_BF16) and float32
# (TOL_FP32, gradients too), reruns bit for bit, one launch a direction on
# the lanes the plan names (16-byte vectors; single channels at the
# post_bn's 192, fewer vectors than SMs) and no other K5 launch
HEAD_BN_SHAPES = {"bench_pre_bn": (256, 10240), "bench_post_bn": (256, 192),
                  "dpn68_pre_bn": (256, 16640), "tdnn_pre_bn": (1024, 3072)}
HEAD_BN_GROUPS = 8
HEAD_BN_KEYS = ("bn_train.bn_head_fwd:vector", "bn_train.bn_head_bwd:vector",
                "bn_train.bn_head_fwd:single", "bn_train.bn_head_bwd:single")


def check_bn_head(dev, gen):
    """K5's head design at HEAD_BN_SHAPES in bf16 and float32: forward
    (output, running statistics) and backward against autograd of the plain
    version, the launches a call read off the counts, reruns bit for bit;
    each direction's device time beside its bytes bound, the plain
    version's and F.batch_norm's (training mode, one group) on the same
    inputs. One line a shape; returns the ``bn_train:head`` row (its times:
    the bench step's two head calls in bf16, forward + backward)."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops
    import torch.nn.functional as F

    g = HEAD_BN_GROUPS
    errs = {"bfloat16": 0.0, "float32": 0.0, "float32_grad": 0.0}
    by_shape = {}
    for name, shape in HEAD_BN_SHAPES.items():
        c = shape[1]
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            plan = ops.bn_train_plan(shape, g, dtype, 0, False)
            if plan["design"] != "head":
                fail(f"bn_head: {shape} {dn} takes {plan['design']}")
            launched = {f"bn_train.bn_head_{d}:{plan['lanes']}": 1 for d in ("fwd", "bwd")}
            x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            rm = 0.1 * torch.randn(c, generator=gen, device=dev)
            rv = 0.5 + torch.rand(c, generator=gen, device=dev)
            runs = []
            for fn in (ops.bn_train, ops.bn_train_reference, ops.bn_train):
                xi, st = x.detach().clone().requires_grad_(True), [rm.clone(), rv.clone()]
                before = kernels.function_launch_counts()
                y = fn(xi, st[0], st[1], groups=g)
                y.backward(dy)
                torch.cuda.synchronize()
                delta = {k: v - before[k] for k, v in kernels.function_launch_counts().items()
                         if v != before[k] and k.startswith("bn_train.")}
                if fn is ops.bn_train and delta != launched:
                    fail(f"bn_head: {shape} {dn} launched {delta}, not one a direction")
                runs.append((y.detach(), xi.grad, *st))
            (y, dx, m, v), (yr, dxr, mr, vr), again = runs
            ey = max(rel_err(y, yr), rel_err(m, mr), rel_err(v, vr))
            eg = rel_err(dx, dxr)
            if dtype == torch.float32:
                errs["float32"] = max(errs["float32"], ey)
                errs["float32_grad"] = max(errs["float32_grad"], eg)
                bad = ey > TOL_FP32 or eg > TOL_FP32
            else:
                errs["bfloat16"] = max(errs["bfloat16"], ey, eg)
                bad = max(ey, eg) > TOL_TRAIN_BF16
            if bad:
                fail(f"bn_head: {shape} {dn} rel err {ey}, gradient {eg}")
            if not all(torch.equal(a, b) for a, b in zip(runs[0], again)):
                fail(f"bn_head: two runs at {shape} {dn} differ")
            del runs, again, y, dx, yr, dxr

            st = [rm.clone(), rv.clone()]
            xi = x.detach().requires_grad_(True)
            yk = ops.bn_train(xi, st[0], st[1], groups=g)
            yp = ops.bn_train_reference(xi, st[0].clone(), st[1].clone(), groups=g)
            li = x.detach().requires_grad_(True)
            lm, lv = rm.clone(), rv.clone()
            yl = F.batch_norm(li, lm, lv, training=True, momentum=1 - ops.BN_MOMENTUM,
                              eps=ops.BN_EPSILON)

            def k_fwd():
                with torch.no_grad():
                    return ops.bn_train(x, st[0], st[1], groups=g)

            def p_fwd():
                with torch.no_grad():
                    return ops.bn_train_reference(x, rm.clone(), rv.clone(), groups=g)

            def l_fwd():
                with torch.no_grad():
                    return F.batch_norm(x, lm, lv, training=True,
                                        momentum=1 - ops.BN_MOMENTUM, eps=ops.BN_EPSILON)

            k_bwd = lambda: torch.autograd.grad(yk, [xi], dy, retain_graph=True)  # noqa: E731
            p_bwd = lambda: torch.autograd.grad(yp, [xi], dy, retain_graph=True)  # noqa: E731
            l_bwd = lambda: torch.autograd.grad(yl, [li], dy, retain_graph=True)  # noqa: E731
            nbytes = x.numel() * x.element_size()
            # x read, y written; x, dy read, dx written (the (G, C)
            # statistics and the running update add < 1%)
            row = dict(shape=list(shape), groups=g, dtype=dn, plan=dict(plan),
                       max_rel_err=ey, max_rel_err_grad=eg,
                       device_ms_fwd=device_ms(k_fwd, "head_fwd_kernel"),
                       device_ms_bwd=device_ms(k_bwd, "head_bwd_kernel"),
                       call_device_ms_fwd=device_ms(k_fwd), call_device_ms_bwd=device_ms(k_bwd),
                       plain_device_ms_fwd=device_ms(p_fwd), plain_device_ms_bwd=device_ms(p_bwd),
                       library_device_ms_fwd=device_ms(l_fwd),
                       library_device_ms_bwd=device_ms(l_bwd),
                       host_ms_fwd=time_ms(k_fwd, reps=20), host_ms_bwd=time_ms(k_bwd, reps=20),
                       bound_ms_fwd=bound_ms(2 * nbytes, 8.0 * x.numel(), torch.float32)[0],
                       bound_ms_bwd=bound_ms(3 * nbytes, 12.0 * x.numel(), torch.float32)[0])
            by_shape[f"{name}/{dn}"] = row
            emit({"phase": "kernel", "name": "bn_train:head", "call": name, **row})
            del x, dy, xi, yk, yp, li, yl
            torch.cuda.empty_cache()
    bench = [by_shape[f"{k}/bfloat16"] for k in ("bench_pre_bn", "bench_post_bn")]

    def total(key):
        return sum(r[f"{key}_fwd"] + r[f"{key}_bwd"] for r in bench)

    return dict(name="bn_train:head", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/bn_train.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:117 (_GroupedBN, XLA, "
                         "forward and backward) at the 2-D head inputs (models/res2net.py's "
                         "EmbeddingHead pre_bn / post_bn)",
                functions=("bn_head_fwd", "bn_head_bwd"), library="bn_train",
                max_abs_err=errs["bfloat16"], max_rel_err_fp32=errs["float32"],
                max_rel_err_fp32_grad=errs["float32_grad"], tolerance=TOL_TRAIN_BF16,
                tolerance_fp32=TOL_FP32, reruns_bit_equal=True, dtype="bfloat16",
                per="the bench step's two head calls, (256, 10240) and (256, 192) at bn_groups "
                    "8, forward + backward, device time",
                ms=total("device_ms"), host_ms=total("host_ms"),
                plain_ms=total("plain_device_ms"), bound_ms=total("bound_ms"),
                bound_by="bytes", library_ms=total("library_device_ms"),
                library_call="F.batch_norm, training mode at one group, forward + backward",
                by_shape=by_shape)


# K9 / K9b at the bench step's four stride-1 stage shapes (res2net50_w8_s6_c16,
# B=256, 200 frames: w = 8, 16, 32, 64 at s = 6) and res2net200_att's four
# (B=128, 200 frames: w = 24, 48, 96, 192 at s = 4; not on the bench step),
# at bn_groups 8: (x shape, w, s)
SPLIT_TRAIN_SHAPES = (((256, 48, 200, 80), 8, 6), ((256, 96, 100, 40), 16, 6),
                      ((256, 192, 50, 20), 32, 6), ((256, 384, 25, 10), 64, 6),
                      ((128, 96, 200, 80), 24, 4), ((128, 192, 100, 40), 48, 4),
                      ((128, 384, 50, 20), 96, 4), ((128, 768, 25, 10), 192, 4))
# Each run is held against the plain version in float64 that takes the
# run's own relu decisions (split_chain_train_reference(relu_masks=)): a
# decision at a value within rounding of zero may go either way, and moves
# the gradient there by the whole upstream value. Every decision that went
# the other way from the float64 chain must be such a tie: within RELU_TIE
# of zero for float32, within SPLIT_TRAIN_TIE_BF16 for bf16 (its groups'
# inputs carry bf16 rounding). float32 on the first rows of each shape (two
# of each of the 8 BN groups), within twice the float32 plain version's own
# error (against float64 on its own decisions) or TOL_FP32; bf16 on the
# whole shape, on its bf16 inputs, relative to each tensor's largest
# magnitude: out, dx and dW within K2's chain tolerance, the running
# statistics within K5's
SPLIT_TRAIN_FP64_ROWS = 16
SPLIT_TRAIN_TIE_BF16 = 2 ** -5
TOL_SPLIT_TRAIN = {"bf16": TOL_BF16["split_conv"], "stats_bf16": TOL_TRAIN_BF16}


def chain_errors(got, want):
    """Relative errors (to each tensor's largest magnitude) of out, dx, dW
    and of the running statistics (the largest over groups)."""
    return [rel_err(a, b) for a, b in zip(got[:3], want[:3])] + [
        max(rel_err(a, b) for a, b in zip(got[3:], want[3:]))]


def chain_run(fn, x, weight, dout, rm, rv, groups, dtype, **kw):
    """fn's output, dx, dW and updated running statistics (copies), in
    ``dtype``, for the cotangent ``dout``."""
    xi = x.to(dtype).detach().clone().requires_grad_(True)
    wi = weight.to(dtype).detach().clone().requires_grad_(True)
    st = torch.float64 if dtype == torch.float64 else torch.float32
    rms, rvs = [r.to(st).clone() for r in rm], [r.to(st).clone() for r in rv]
    y = fn(xi, wi, rms, rvs, groups, None, **kw)
    y.backward(dout.to(dtype))
    return [y.detach(), xi.grad, wi.grad] + rms + rvs


def float64_with_decisions(run, x, weight, dout, rm, rv, groups, w, s):
    """The plain chain in float64 on ``run``'s relu decisions (its output
    > 0 in each group's slice): (its results, the flip count, the largest
    |float64 pre-relu value| at a flip)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    masks = [run[0][:, i * w: (i + 1) * w] > 0 for i in range(s - 1)]
    pre = []
    ref = chain_run(functools.partial(rn.split_chain_train_reference, relu_masks=masks,
                                      pre_relu=pre), x, weight, dout, rm, rv, groups,
                    torch.float64)
    flips = [m != (v > 0) for m, v in zip(masks, pre)]
    worst = max((float(v[f].abs().max()) for v, f in zip(pre, flips) if f.any()), default=0.0)
    return ref, sum(int(f.sum()) for f in flips), worst


def check_split_train(dev, gen, chains, groups):
    """K9 / K9b at SPLIT_TRAIN_SHAPES: against the plain version (bf16 and
    float32 vs float64), launch counts per call, reruns bit for bit; the
    kernels' device time forward and backward beside the bytes bound, the
    plain version's time and today's route's (cuDNN conv + K5 + adds + cat,
    ``_split_chain_span`` without a mesh), and cuDNN's convs alone (the
    library yardstick). Returns the kernels line's K9 and K9b rows, their
    times summed over one bench training step."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    import torch.nn.functional as F

    detail, fp32, reruns = [], [], 0
    err16 = stats16 = 0.0
    keys = ("ms", "device_ms", "plain_ms", "route_ms", "library_ms", "bound_ms")
    tot = {d: {k: 0.0 for k in keys} for d in ("fwd", "bwd")}
    for shape, w, s in SPLIT_TRAIN_SHAPES:
        count = chains.get((shape, w, s), 0)
        b, c, t, f = shape
        x = _layout(torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.2)
        weight = torch.randn(((s - 1) * w, w, 3, 3), generator=gen, device=dev) / math.sqrt(9 * w)
        dout = _layout(torch.randn(shape, generator=gen, device=dev))
        rm = [0.1 * torch.randn(w, generator=gen, device=dev) for _ in range(s - 1)]
        rv = [0.5 + torch.rand(w, generator=gen, device=dev) for _ in range(s - 1)]

        args = (rm, rv, groups)
        xb, wb, db = x.bfloat16(), weight.bfloat16(), dout.bfloat16()
        before = kernels.function_launch_counts()
        got = chain_run(rn.split_chain_train, xb, wb, db, *args, torch.bfloat16)
        torch.cuda.synchronize()
        after = kernels.function_launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if launched != k9_launches({(shape, w, s): 1}):
            fail(f"split_train {shape}: launches {launched}")
        if not all(torch.isfinite(v.float()).all() for v in got):
            fail(f"split_train {shape}: non-finite values")
        if not all(torch.equal(a, b2) for a, b2 in zip(got, chain_run(
                rn.split_chain_train, xb, wb, db, *args, torch.bfloat16))):
            fail(f"split_train {shape}: two runs differ")
        reruns += 1
        ref, flips16, tie16 = float64_with_decisions(got, xb, wb, db, *args, w, s)
        e16 = chain_errors(got, ref)
        del got, ref
        rows = SPLIT_TRAIN_FP64_ROWS
        sub = (x[:rows], weight, dout[:rows], *args)
        k32 = chain_run(rn.split_chain_train, *sub, torch.float32)
        p32 = chain_run(rn.split_chain_train_reference, *sub, torch.float32)
        kref, flips32, tie32 = float64_with_decisions(k32, *sub, w, s)
        pref, pflips32, ptie32 = float64_with_decisions(p32, *sub, w, s)
        e32, pe32 = chain_errors(k32, kref), chain_errors(p32, pref)
        del k32, p32, kref, pref
        fp32.append(dict(shape=[rows, c, t, f], kernel=e32, plain=pe32, kernel_flips=flips32,
                         kernel_worst_tie=tie32, plain_flips=pflips32, plain_worst_tie=ptie32))
        if any(e > max(TOL_FP32, 2 * p) for e, p in zip(e32, pe32)):
            fail(f"split_train {shape}: float32 errors {e32} vs the plain version's {pe32}")
        if max(tie32, ptie32) > RELU_TIE or tie16 > SPLIT_TRAIN_TIE_BF16:
            fail(f"split_train {shape}: relu flips beyond a tie: float32 {tie32} (plain "
                 f"{ptie32}), bf16 {tie16}")
        if max(e16[:3]) > TOL_SPLIT_TRAIN["bf16"] or e16[3] > TOL_SPLIT_TRAIN["stats_bf16"]:
            fail(f"split_train {shape}: bf16 errors {e16}")
        err16, stats16 = max(err16, *e16[:3]), max(stats16, e16[3])

        # times, bf16: the call by CUDA events (host included), the kernels'
        # own device time by the profiler
        rms, rvs = [r.clone() for r in rm], [r.clone() for r in rv]

        def chain(fn):
            return lambda xi, wi: fn(xi, wi, rms, rvs, groups, None)

        fwd, bwd = time_fwd_bwd(chain(rn.split_chain_train), [xb, wb], db)
        pfwd, pbwd = time_fwd_bwd(chain(rn.split_chain_train_reference), [xb, wb], db)
        rfwd, rbwd = time_fwd_bwd(chain(rn._split_chain_span), [xb, wb], db)
        with torch.no_grad():
            dfwd = device_ms(lambda: rn.split_chain_train(xb, wb, rms, rvs, groups), "k9_")
        xl, wl = xb.detach().requires_grad_(True), wb.detach().requires_grad_(True)
        y = rn.split_chain_train(xl, wl, rms, rvs, groups)
        dbwd = device_ms(lambda: torch.autograd.grad(y, [xl, wl], db, retain_graph=True), "k9b_")
        del y, xl, wl
        # cuDNN's s-1 group convs alone: forward, and dgrad + wgrad
        xg = _layout(xb[:, :w])
        lf, lb = time_fwd_bwd(lambda xi, wi: F.conv2d(xi, wi, padding=1),
                              [xg, wb[:w].contiguous()], _layout(db[:, :w]))
        lf, lb = (s - 1) * lf, (s - 1) * lb
        flops = (s - 1) * 2 * b * t * f * 9 * w * w
        unit = 2 * b * c * t * f  # one activation in bf16
        bf, byf = bound_ms(2 * unit + 2 * wb.numel(), flops, torch.bfloat16)
        bb, byb = bound_ms(3 * unit + 4 * wb.numel(), 2 * flops, torch.bfloat16)
        row = dict(shape=list(shape), width=w, split=s, chains_per_microbatch=count,
                   plan=rn.split_train_plan(w, s, shape, groups, torch.bfloat16),
                   errors_bf16=e16, bf16_flips=flips16, bf16_worst_tie=tie16,
                   errors_fp32=fp32[-1],
                   ms_fwd=fwd, ms_bwd=bwd, device_ms_fwd=dfwd, device_ms_bwd=dbwd,
                   plain_ms_fwd=pfwd, plain_ms_bwd=pbwd, route_ms_fwd=rfwd, route_ms_bwd=rbwd,
                   library_ms_fwd=lf, library_ms_bwd=lb, bound_ms_fwd=bf, bound_ms_bwd=bb,
                   bound_by_fwd=byf, bound_by_bwd=byb)
        detail.append(row)
        for d, vals in (("fwd", (fwd, dfwd, pfwd, rfwd, lf, bf)), ("bwd", (bwd, dbwd, pbwd, rbwd,
                                                                          lb, bb))):
            for k, v in zip(keys, vals):
                tot[d][k] += TRAIN_ACCUM * count * v
        del x, dout, xb, db, xg
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "split_train", "shapes": detail,
          "reruns_bit_equal": reruns, "tolerance": {**TOL_SPLIT_TRAIN, "fp32": "max(TOL_FP32, "
                                                    "2 x the float32 plain version's error)"}})
    rows = []
    for d, name, fns, what in (
            ("fwd", "split_train", ("split_train_fwd", "split_train_finish"), "forward"),
            ("bwd", "split_train_bwd", ("split_train_bwd_stats", "split_train_bwd_grad"),
             "backward")):
        t_ = tot[d]
        rows.append(dict(
            name=name, route="cuda", library="split_train", functions=fns,
            source="voxsrc2020_speaker_verification_tpu_torch/csrc/split_train.cu",
            replaces="voxsrc2020_speaker_verification_tpu/models/res2net.py:82 "
                     f"(Res2NetSplitConv stride-1 branch in training, XLA, {what})",
            max_abs_err=err16, max_abs_err_is="relative to each tensor's largest magnitude",
            max_rel_err_stats_bf16=stats16, fp32_vs_fp64=fp32, tolerance=TOL_SPLIT_TRAIN,
            reruns_bit_equal=reruns, dtype="bfloat16",
            per=f"training step, B={TRAIN_BATCH} x A={TRAIN_ACCUM} x {TRAIN_FRAMES} frames "
                f"({what}, the step's 13 stride-1 chains a microbatch)",
            ms=t_["ms"], device_ms=t_["device_ms"], plain_ms=t_["plain_ms"],
            route_ms=t_["route_ms"], bound_ms=t_["bound_ms"], bound_by="bytes",
            library_ms=t_["library_ms"],
            library_call="F.conv2d (cuDNN) of each group alone" + (
                "" if d == "fwd" else ", dgrad + wgrad") + ": the convs only"))
    return rows


# K11 / K11b (the stride-2 split stage in training): the bench step's three
# stride-2 shapes (B = 256, bn_groups 8; w = 16, 32, 64 at s = 6) and
# res2net200_att's and the north-star's (B = 128, 200 frames; w = 48, 96,
# 192 at s = 4): (x shape, w, s). Held as K9 / K9b are: bf16 on the whole
# shape against the plain version in float64 on the run's own relu
# decisions (out, dx and dW within K2's chain tolerance, the running
# statistics within K5's), the tail bit-equal to the plain version's in
# bf16 and float32; float32 on the first STRIDE2_TRAIN_FP64_ROWS rows
# within twice the float32 plain version's own error or TOL_FP32
STRIDE2_TRAIN_SHAPES = (((256, 96, 200, 80), 16, 6), ((256, 192, 100, 40), 32, 6),
                        ((256, 384, 50, 20), 64, 6), ((128, 192, 200, 80), 48, 4),
                        ((128, 384, 100, 40), 96, 4), ((128, 768, 50, 20), 192, 4))
STRIDE2_TRAIN_FP64_ROWS = 16


def stage_run(fn, x, weight, dout, rm, rv, groups, dtype, **kw):
    """fn's output, dx, dW and updated running statistics (copies), in
    ``dtype``, for the cotangent ``dout`` (a stride-2 stage in training)."""
    xi = x.to(dtype).detach().clone().requires_grad_(True)
    wi = weight.to(dtype).detach().clone().requires_grad_(True)
    st = torch.float64 if dtype == torch.float64 else torch.float32
    rms, rvs = [r.to(st).clone() for r in rm], [r.to(st).clone() for r in rv]
    y = fn(xi, wi, rms, rvs, groups, **kw)
    y.backward(dout.to(dtype))
    return [y.detach(), xi.grad, wi.grad] + rms + rvs


def stage_float64(run, x, weight, dout, rm, rv, groups, w, s):
    """The plain stride-2 stage in float64 on ``run``'s relu decisions:
    (its results, the flip count, the largest |float64 pre-relu value| at a
    flip)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    masks = [run[0][:, i * w: (i + 1) * w] > 0 for i in range(s - 1)]
    pre = []
    ref = stage_run(functools.partial(rn.split_stride2_train_reference, relu_masks=masks,
                                      pre_relu=pre), x, weight, dout, rm, rv, groups,
                    torch.float64)
    flips = [m != (v > 0) for m, v in zip(masks, pre)]
    worst = max((float(v[f].abs().max()) for v, f in zip(pre, flips) if f.any()), default=0.0)
    return ref, sum(int(f.sum()) for f in flips), worst


K11_DEVICE = ("fwd_mma_kernel", "fwd_fma_kernel", "finish_kernel")
K11B_DEVICE = ("bwd_stats_kernel", "grad_mma_kernel", "grad_fma_kernel")


def check_split_stride2_train(dev, gen, stages, groups):
    """K11 / K11b at STRIDE2_TRAIN_SHAPES: against the plain version (bf16
    and float32 vs float64 on each run's own relu decisions), the tail
    bit-equal to the plain version's, launch counts a call, reruns bit for
    bit; the kernels' device time forward and backward beside the bytes
    bound, the plain version's time, today's route (``_split_stride2_span``
    without a mesh: the padded copy, cuDNN's grouped conv, K5, the pool and
    the cat, through autograd) and cuDNN's grouped conv alone (the library
    yardstick: forward; dgrad + wgrad). Returns the kernels line's K11 and
    K11b rows, their times summed over one bench training step (``stages``:
    the bench step's stride-2 stages a microbatch)."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops
    import torch.nn.functional as F

    detail, fp32, reruns, tails = [], [], 0, True
    err16 = stats16 = 0.0
    keys = ("ms", "device_ms", "stage_device_ms", "plain_ms", "route_ms", "route_device_ms",
            "library_ms", "bound_ms")
    tot = {d: {k: 0.0 for k in keys} for d in ("fwd", "bwd")}
    for shape, w, s in STRIDE2_TRAIN_SHAPES:
        count = stages.get((shape, w, s), 0)
        b, c, t, f = shape
        tout, fout = (t - 1) // 2 + 1, (f - 1) // 2 + 1
        tail = slice((s - 1) * w, None)
        x = _layout(torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.2)
        weight = torch.randn(((s - 1) * w, w, 3, 3), generator=gen, device=dev) / math.sqrt(9 * w)
        dout = _layout(torch.randn((b, c, tout, fout), generator=gen, device=dev))
        rm = [0.1 * torch.randn(w, generator=gen, device=dev) for _ in range(s - 1)]
        rv = [0.5 + torch.rand(w, generator=gen, device=dev) for _ in range(s - 1)]
        args = (rm, rv, groups)
        xb, wb, db = x.bfloat16(), weight.bfloat16(), dout.bfloat16()
        before = kernels.function_launch_counts()
        got = stage_run(rn.split_stride2_train, xb, wb, db, *args, torch.bfloat16)
        torch.cuda.synchronize()
        after = kernels.function_launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if launched != k11_launches({shape: 1}):
            fail(f"split_stride2_train {shape}: launches {launched}")
        if not all(torch.isfinite(v.float()).all() for v in got):
            fail(f"split_stride2_train {shape}: non-finite values")
        if not all(torch.equal(a, b2) for a, b2 in zip(got, stage_run(
                rn.split_stride2_train, xb, wb, db, *args, torch.bfloat16))):
            fail(f"split_stride2_train {shape}: two runs differ")
        reruns += 1
        t16 = torch.equal(got[0][:, tail], rn.split_stride2_train_reference(
            xb, wb, [r.clone() for r in rm], [r.clone() for r in rv], groups)[:, tail])
        ref, flips16, tie16 = stage_float64(got, xb, wb, db, *args, w, s)
        e16 = chain_errors(got, ref)
        del got, ref
        rows = STRIDE2_TRAIN_FP64_ROWS
        sub = (x[:rows], weight, dout[:rows], *args)
        k32 = stage_run(rn.split_stride2_train, *sub, torch.float32)
        p32 = stage_run(rn.split_stride2_train_reference, *sub, torch.float32)
        t32 = torch.equal(k32[0][:, tail], p32[0][:, tail])
        kref, flips32, tie32 = stage_float64(k32, *sub, w, s)
        pref, pflips32, ptie32 = stage_float64(p32, *sub, w, s)
        e32, pe32 = chain_errors(k32, kref), chain_errors(p32, pref)
        del k32, p32, kref, pref
        tails &= t16 and t32
        fp32.append(dict(shape=[rows, c, t, f], kernel=e32, plain=pe32, kernel_flips=flips32,
                         kernel_worst_tie=tie32, plain_flips=pflips32, plain_worst_tie=ptie32))
        if any(e > max(TOL_FP32, 2 * p) for e, p in zip(e32, pe32)):
            fail(f"split_stride2_train {shape}: float32 errors {e32} vs the plain version's "
                 f"{pe32}")
        if max(tie32, ptie32) > RELU_TIE or tie16 > SPLIT_TRAIN_TIE_BF16:
            fail(f"split_stride2_train {shape}: relu flips beyond a tie: float32 {tie32} "
                 f"(plain {ptie32}), bf16 {tie16}")
        if max(e16[:3]) > TOL_SPLIT_TRAIN["bf16"] or e16[3] > TOL_SPLIT_TRAIN["stats_bf16"]:
            fail(f"split_stride2_train {shape}: bf16 errors {e16}")
        if not (t16 and t32):
            fail(f"split_stride2_train {shape}: the tail differs from avg_pool_3x3's "
                 f"(bf16 {t16}, float32 {t32})")
        err16, stats16 = max(err16, *e16[:3]), max(stats16, e16[3])

        # times, bf16: the call by CUDA events (host included), the kernels'
        # own device time by the profiler; today's route through autograd
        rms, rvs = [r.clone() for r in rm], [r.clone() for r in rv]

        def stage(fn):
            return lambda xi, wi: fn(xi, wi, rms, rvs, groups)

        fwd, bwd = time_fwd_bwd(stage(rn.split_stride2_train), [xb, wb], db)
        pfwd, pbwd = time_fwd_bwd(stage(rn.split_stride2_train_reference), [xb, wb], db)
        rfwd, rbwd = time_fwd_bwd(stage(rn._split_stride2_span), [xb, wb], db)
        # device ms of K11's / K11b's own kernels, and of the whole call
        # (stage_*: dout's alignment copy included, as the route's device ms
        # includes everything; the kernels stage the OIHW weight themselves)
        with torch.no_grad():
            k11 = lambda: rn.split_stride2_train(xb, wb, rms, rvs, groups)  # noqa: E731
            dfwd, sfwd = device_ms(k11, K11_DEVICE), device_ms(k11)
            drfwd = device_ms(lambda: rn._split_stride2_span(xb, wb, rms, rvs, groups))
        xl, wl = xb.detach().requires_grad_(True), wb.detach().requires_grad_(True)
        y = rn.split_stride2_train(xl, wl, rms, rvs, groups)
        k11b = lambda: torch.autograd.grad(y, [xl, wl], db, retain_graph=True)  # noqa: E731
        dbwd, sbwd = device_ms(k11b, K11B_DEVICE), device_ms(k11b)
        y = rn._split_stride2_span(xl, wl, rms, rvs, groups)
        drbwd = device_ms(lambda: torch.autograd.grad(y, [xl, wl], db, retain_graph=True))
        del y, xl, wl
        # cuDNN's grouped conv alone on the padded input: forward, and dgrad
        # + wgrad for the groups' cotangent
        xp = ops.fixed_padding(xb, 3)[:, : w * (s - 1)]
        conv = lambda xi, wi: F.conv2d(xi, wi, stride=2, groups=s - 1)  # noqa: E731
        with torch.no_grad():
            lf = device_ms(lambda: conv(xp, wb))
        xl, wl = xp.detach().requires_grad_(True), wb.detach().requires_grad_(True)
        y = conv(xl, wl)
        dz = _layout(db[:, : w * (s - 1)])
        lb = device_ms(lambda: torch.autograd.grad(y, [xl, wl], dz, retain_graph=True))
        del y, xl, wl, xp, dz
        flops = (s - 1) * 2 * b * tout * fout * 9 * w * w
        x_bytes, out_bytes = 2 * b * c * t * f, 2 * b * c * tout * fout
        z_bytes = 2 * b * (s - 1) * w * tout * fout
        # forward: x read, z and the tail written, z read and the groups
        # written; backward: dout's groups (z's size) and z read (the sums),
        # dout, z and x read and dx written (the gradients); the weights
        # each way
        bf, byf = bound_ms(x_bytes + out_bytes + 2 * z_bytes + 2 * wb.numel(), flops,
                           torch.bfloat16)
        bb, byb = bound_ms(3 * z_bytes + out_bytes + 2 * x_bytes + 4 * wb.numel(), 2 * flops,
                           torch.bfloat16)
        row = dict(shape=list(shape), width=w, split=s, stages_per_microbatch=count,
                   plan={k: v for k, v in rn.stride2_train_plan(
                       w, s, shape, groups, torch.bfloat16).items()},
                   errors_bf16=e16, bf16_flips=flips16, bf16_worst_tie=tie16,
                   errors_fp32=fp32[-1], tail_bit_equal=t16 and t32,
                   ms_fwd=fwd, ms_bwd=bwd, device_ms_fwd=dfwd, device_ms_bwd=dbwd,
                   stage_device_ms_fwd=sfwd, stage_device_ms_bwd=sbwd,
                   plain_ms_fwd=pfwd, plain_ms_bwd=pbwd, route_ms_fwd=rfwd, route_ms_bwd=rbwd,
                   route_device_ms_fwd=drfwd, route_device_ms_bwd=drbwd,
                   library_conv_device_ms_fwd=lf, library_conv_device_ms_bwd=lb,
                   bound_ms_fwd=bf, bound_ms_bwd=bb, bound_by_fwd=byf, bound_by_bwd=byb,
                   bound_share_fwd=bf / dfwd, bound_share_bwd=bb / dbwd)
        detail.append(row)
        for d, vals in (("fwd", (fwd, dfwd, sfwd, pfwd, rfwd, drfwd, lf, bf)),
                        ("bwd", (bwd, dbwd, sbwd, pbwd, rbwd, drbwd, lb, bb))):
            for k, v in zip(keys, vals):
                tot[d][k] += TRAIN_ACCUM * count * v
        del x, dout, xb, db
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "split_stride2_train", "shapes": detail,
          "reruns_bit_equal": reruns, "tail_bit_equal": tails,
          "tolerance": {**TOL_SPLIT_TRAIN, "fp32": "max(TOL_FP32, 2 x the float32 plain "
                                                   "version's error)"}})
    rows = []
    for d, name, fns, what in (
            ("fwd", "split_stride2_train", ("split_stride2_train_fwd",
                                            "split_stride2_train_finish"), "forward"),
            ("bwd", "split_stride2_train_bwd", ("split_stride2_train_bwd_stats",
                                                "split_stride2_train_bwd_grad"), "backward")):
        t_ = tot[d]
        rows.append(dict(
            name=name, route="cuda", library="split_stride2_train", functions=fns,
            source="voxsrc2020_speaker_verification_tpu_torch/csrc/split_stride2_train.cu",
            replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:223 (grouped_conv "
                     "custom_vjp, forward 244, backward 248-281) as models/res2net.py:52-80 "
                     f"calls it in training with BN, avg_pool_3x3 and the concat (XLA, {what})",
            max_abs_err=err16, max_abs_err_is="relative to each tensor's largest magnitude",
            max_rel_err_stats_bf16=stats16, fp32_vs_fp64=fp32, tolerance=TOL_SPLIT_TRAIN,
            reruns_bit_equal=reruns, tail_bit_equal=tails, dtype="bfloat16",
            per=f"training step, B={TRAIN_BATCH} x A={TRAIN_ACCUM} x {TRAIN_FRAMES} frames "
                f"({what}, the step's 3 stride-2 stages a microbatch)",
            ms=t_["ms"], device_ms=t_["device_ms"], stage_device_ms=t_["stage_device_ms"],
            stage_device_ms_is="every device kernel of the stage's call: K11 / K11b's and "
                               "dout's alignment copy",
            bound_share=t_["bound_ms"] / t_["device_ms"],
            bound_share_is="bound_ms / device_ms over the bench step's stages",
            plain_ms=t_["plain_ms"], route_ms=t_["route_ms"], route_device_ms=t_["route_device_ms"],
            bound_ms=t_["bound_ms"], bound_by="bytes", library_ms=t_["library_ms"],
            library_call="cuDNN's grouped conv at stride 2 alone (F.conv2d, groups=s-1, on the "
                         "padded input), device ms" + ("" if d == "fwd" else ", dgrad + wgrad")
                         + "; route_*: the route K11 / K11b replaced (F.pad + grouped conv + K5 "
                           "+ avg_pool_3x3 + cat, through autograd)"))
    return rows


def check_stats_pool_bwd(dev, gen, head_shape):
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    c, t, f = head_shape
    x = _layout(torch.randn((TRAIN_BATCH, c, t, f), generator=gen, device=dev) * 2 + 1)
    dout = _layout(torch.randn((TRAIN_BATCH, 2 * c, 1, f), generator=gen, device=dev))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        grads = []
        for fn in (ops.stats_pool, ops.stats_pool_reference, ops.stats_pool):
            xi = x.detach().to(dtype).requires_grad_(True)
            fn(xi, None).backward(dout.to(dtype))
            grads.append(xi.grad)
        errs[dtype] = rel_err(*grads[:2])
        if not torch.equal(grads[0], grads[2]):
            fail(f"stats_pool_bwd: two runs on the same {dtype} inputs differ")
    xb, db = x.bfloat16(), dout.bfloat16()
    _, ms = time_fwd_bwd(ops.stats_pool, [xb], db)
    _, plain = time_fwd_bwd(ops.stats_pool_reference, [xb], db)
    xi = xb.detach().requires_grad_(True)
    y = ops.stats_pool(xi)
    dev_ms = device_ms(lambda: torch.autograd.grad(y, [xi], db, retain_graph=True),
                       "stats_pool_bwd_kernel")
    del y, xi
    bms, by = bound_ms(2 * 2 * xb.numel() + 2 * db.numel(), 3.0 * xb.numel(), torch.float32)
    lib = var_mean_call(xb, backward=True)
    if errs[torch.float32] > TOL_FP32 or errs[torch.bfloat16] > TOL_BF16["stats_pool"]:
        fail(f"stats_pool_bwd: rel err {errs}")
    return dict(name="stats_pool_bwd", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/stats_pool_bwd.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:487 "
                         "(stats_pool backward, JAX autodiff, XLA)",
                max_abs_err=errs[torch.bfloat16], max_rel_err_fp32=errs[torch.float32],
                tolerance=TOL_BF16["stats_pool"], dtype="bfloat16",
                per=f"training step (A={TRAIN_ACCUM} calls of (B, C, T, F)="
                    f"{(TRAIN_BATCH, c, t, f)})",
                ms=TRAIN_ACCUM * ms, device_ms=TRAIN_ACCUM * dev_ms, plain_ms=TRAIN_ACCUM * plain,
                bound_ms=TRAIN_ACCUM * bms, bound_by=by,
                library_ms=TRAIN_ACCUM * time_ms(lib, reps=20),
                library_device_ms=TRAIN_ACCUM * device_ms(lib),
                library_call="autograd backward of torch.var_mean over T",
                reruns_bit_equal=True)


def check_margin_ce(dev, gen, num_centers, num_classes):
    from voxsrc2020_speaker_verification_tpu_torch.losses.projections import (
        margin_ce, margin_ce_reference)

    shape = (num_centers, TRAIN_BATCH, num_classes)
    cos = (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * 0.998
    labels = torch.randint(0, num_classes, (TRAIN_BATCH,), generator=gen, device=dev)
    dloss = torch.rand(TRAIN_BATCH, generator=gen, device=dev) / TRAIN_BATCH
    outs = []
    for fn in (margin_ce, margin_ce_reference):
        ci = cos.clone().requires_grad_(True)
        loss, correct = fn(ci, labels, 32.0, 0.2)
        loss.backward(dloss)
        outs.append((loss.detach(), correct, ci.grad))
    (l, c, d), (lr_, cr, dr) = outs
    err = max(rel_err(l, lr_), rel_err(d, dr))
    ci = cos.clone().requires_grad_(True)
    loss, correct = margin_ce(ci, labels, 32.0, 0.2)
    loss.backward(dloss)
    rerun_equal = torch.equal(loss.detach(), l) and torch.equal(correct, c) and torch.equal(ci.grad, d)
    del ci, loss, correct
    if err > TOL_FP32 or not torch.equal(c, cr) or not rerun_equal:
        fail(f"margin_ce: rel err {err}, correct flags equal {torch.equal(c, cr)}, "
             f"reruns equal {rerun_equal}")
    fwd, bwd = time_fwd_bwd(lambda x: margin_ce(x, labels, 32.0, 0.2)[0], [cos], dloss)
    pfwd, pbwd = time_fwd_bwd(lambda x: margin_ce_reference(x, labels, 32.0, 0.2)[0], [cos], dloss)
    ci = cos.detach().requires_grad_(True)
    loss = margin_ce(ci, labels, 32.0, 0.2)[0]
    dev_fwd = device_ms(lambda: margin_ce(cos, labels, 32.0, 0.2), "margin_ce_fwd_kernel")
    dev_bwd = device_ms(lambda: torch.autograd.grad(loss, [ci], dloss, retain_graph=True),
                        "margin_ce_bwd_kernel")
    del loss, ci
    # forward reads cos_all once; backward reads it and writes dcos_all
    bms, by = bound_ms(3 * 4 * cos.numel(), 30.0 * cos.numel(), torch.float32)
    stream = check_margin_ce_stream(dev, gen)
    emit({"phase": "kernel", "name": "margin_ce", "shape": list(shape), "ms_fwd": fwd,
          "ms_bwd": bwd, "plain_ms_fwd": pfwd, "plain_ms_bwd": pbwd, "stream": stream})
    return dict(name="margin_ce", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/margin_ce.cu",
                replaces="voxsrc2020_speaker_verification_tpu/losses/projections.py:96 "
                         "(sc_cm_linear + CE of training/trainer.py:152, XLA, forward and backward)",
                max_abs_err=err, max_rel_err_fp32=err, tolerance=TOL_FP32, dtype="float32",
                per=f"training step (A={TRAIN_ACCUM} calls on cos_all {shape}, forward + backward)",
                ms=TRAIN_ACCUM * (fwd + bwd), device_ms=TRAIN_ACCUM * (dev_fwd + dev_bwd),
                plain_ms=TRAIN_ACCUM * (pfwd + pbwd),
                device_ms_fwd=dev_fwd, device_ms_bwd=dev_bwd,
                bound_ms=TRAIN_ACCUM * bms, bound_by=by, library_ms=None,
                library_note="none: no single PyTorch call does max over centers, "
                             "margin and cross-entropy", reruns_bit_equal=rerun_equal,
                paths={"slab": {"shape": list(shape), "note": "the training shape"},
                       "stream": stream})


def check_margin_ce_stream(dev, gen):
    """K6's streaming path, which takes the rows its slab path refuses: at
    K = 2, C = 30000 (B = 256; a 240 KB row) timed and against autograd of
    the plain version, and at K = 10, C = 5994 checked; one launch a
    direction on the streaming path, reruns bit for bit."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.losses.projections import (
        margin_ce, margin_ce_plan, margin_ce_reference)

    errs = {}
    for k, b, c in ((10, 64, 5994), (2, TRAIN_BATCH, 30000)):
        if margin_ce_plan(k, c)[0] != "stream":
            fail(f"margin_ce: ({k}, {c}) is not on the streaming path")
        cos = (torch.rand((k, b, c), generator=gen, device=dev) * 2 - 1) * 0.998
        cos[1, :, :40] = cos[0, :, :40]  # ties between centers
        cos[0, 0, 7] = 1.0               # a cosine of exactly 1 at a non-label column
        labels = torch.randint(0, c, (b,), generator=gen, device=dev)
        dloss = torch.rand(b, generator=gen, device=dev) / b
        outs = []
        for fn in (margin_ce, margin_ce_reference, margin_ce):
            ci = cos.clone().requires_grad_(True)
            before = dict(kernels.MARGIN_CE.fn_launches)
            loss, correct = fn(ci, labels, 32.0, 0.2)
            loss.backward(dloss)
            launched = {f: n - before[f] for f, n in kernels.MARGIN_CE.fn_launches.items()
                        if n != before[f]}
            if fn is margin_ce and launched != {"margin_ce_fwd:stream": 1,
                                                "margin_ce_bwd:stream": 1}:
                fail(f"margin_ce ({k}, {b}, {c}): launched {launched}")
            outs.append((loss.detach(), correct, ci.grad))
        (l, cr, d), (lr_, crr, dr), again = outs
        err = max(rel_err(l, lr_), rel_err(d, dr))
        if (err > TOL_FP32 or not torch.equal(cr, crr) or not torch.isfinite(d).all()
                or not all(torch.equal(x, y) for x, y in zip((l, cr, d), again))):
            fail(f"margin_ce stream ({k}, {b}, {c}): rel err {err}, flags equal "
                 f"{torch.equal(cr, crr)}, or reruns differ")
        errs[f"K{k}_C{c}"] = err
        del outs, again, d, dr
    shape = (2, TRAIN_BATCH, 30000)
    fwd, bwd = time_fwd_bwd(lambda x: margin_ce(x, labels, 32.0, 0.2)[0], [cos], dloss)
    pfwd, pbwd = time_fwd_bwd(lambda x: margin_ce_reference(x, labels, 32.0, 0.2)[0], [cos], dloss)
    ci = cos.detach().requires_grad_(True)
    loss = margin_ce(ci, labels, 32.0, 0.2)[0]
    dev_fwd = device_ms(lambda: margin_ce(cos, labels, 32.0, 0.2), "margin_ce_stream_fwd_kernel")
    dev_bwd = device_ms(lambda: torch.autograd.grad(loss, [ci], dloss, retain_graph=True),
                        "margin_ce_stream_bwd_kernel")
    del loss, ci
    bms, by = bound_ms(3 * 4 * cos.numel(), 30.0 * cos.numel(), torch.float32)
    return dict(kernels="margin_ce_stream_fwd_kernel / margin_ce_stream_bwd_kernel",
                shape=list(shape), max_rel_err_fp32=errs, tolerance=TOL_FP32,
                per="one forward + backward", ms=fwd + bwd, device_ms=dev_fwd + dev_bwd,
                device_ms_fwd=dev_fwd, device_ms_bwd=dev_bwd, plain_ms=pfwd + pbwd,
                bound_ms=bms, bound_by=by, reruns_bit_equal=True)


def check_sliding_cmvn(dev):
    """K7 at the shapes ``cli.extract --cmvn device`` gives it: a batch of
    CMVN_BATCH at every bucket with padded rows (at the largest bucket one
    row of CMVN_PAST_N frames, whose tiles past n read the last window far
    to their left), and one utterance beyond the largest bucket at its exact
    length (60,000 frames); centred and trailing, with and without
    norm_vars, against the float64 plain version on every frame, and the
    centred CMN against the host's float64 ``sliding_cmn_np`` on every valid
    frame; one launch a call; reruns bit for bit. Device time of the kernel
    and of the plain version at every shape (centred CMN, the extraction's
    flags), and the kernel with norm_vars at the largest bucket."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np
    from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn

    rng = np.random.RandomState(SEED + 31)
    err_host = err_plain = 0.0
    shapes = [(CMVN_BATCH, t) for t in CMVN_BUCKETS] + [(1, CMVN_LONG)]
    for b, t in shapes:
        x = (rng.randn(b, t, FEAT_DIM) * 3 + 12).astype(np.float32)
        n = np.array([t] + list(rng.randint(1, t + 1, b - 1)), np.int32)
        if t == CMVN_BUCKETS[-1]:
            n[1] = CMVN_PAST_N
        xs, ns = torch.from_numpy(x).to(dev), torch.from_numpy(n).to(dev)
        for kw in CMVN_FLAGS:
            before = kernels.SLIDING_CMVN.launches
            got = cmvn.sliding_cmvn(xs, ns, **kw)
            if kernels.SLIDING_CMVN.launches - before != 1:
                fail(f"sliding_cmvn at {(b, t, kw)}: {kernels.SLIDING_CMVN.launches - before} "
                     "K7 launches, expected 1")
            err_plain = max(err_plain, abs_err(got, cmvn.sliding_cmvn_reference(xs, ns, **kw)))
            if not torch.equal(got, cmvn.sliding_cmvn(xs, ns, **kw)):
                fail(f"sliding_cmvn: two runs at {(b, t, kw)} differ")
        got = cmvn.sliding_cmvn(xs, ns).cpu().numpy()
        err_host = max(err_host, max(float(np.abs(got[i, :n[i]] - sliding_cmn_np(x[i, :n[i]])).max())
                                     for i in range(b)))
    if max(err_host, err_plain) > TOL_CMVN:
        fail(f"sliding_cmvn: max |kernel - float64| {err_host} (host), {err_plain} (plain) "
             f"> {TOL_CMVN}")
    by_shape = {}
    for b, t in shapes:
        x = torch.from_numpy((rng.randn(b, t, FEAT_DIM) * 3 + 12).astype(np.float32)).to(dev)
        n = torch.from_numpy(rng.randint(t // 2, t + 1, b).astype(np.int32)).to(dev)
        # bytes: x read once, y written once, the counts read; ~8 float64
        # operations a frame and bin (the prefixes, the mean, the difference)
        bms, by = bound_ms(2 * 4 * x.numel() + 4 * b, 8.0 * x.numel(), torch.float64)
        row = dict(device_ms=device_ms(lambda: cmvn.sliding_cmvn(x, n), "sliding_cmvn_kernel"),
                   plain_device_ms=device_ms(lambda: cmvn.sliding_cmvn_reference(x, n)),
                   bound_ms=bms, bound_by=by,
                   plan={k: v for k, v in cmvn.sliding_cmvn_plan(
                       b, t, FEAT_DIM, 300, True, False, 100, kernels.num_sms(dev)).items()
                         if k in ("tt", "fb", "grid", "smem")})
        if (b, t) == (CMVN_BATCH, CMVN_BUCKETS[-1]):
            timed = dict(row, ms=time_ms(lambda: cmvn.sliding_cmvn(x, n), reps=20),
                         plain_ms=time_ms(lambda: cmvn.sliding_cmvn_reference(x, n), reps=20),
                         device_ms_norm_vars=device_ms(
                             lambda: cmvn.sliding_cmvn(x, n, norm_vars=True),
                             "sliding_cmvn_kernel"))
        by_shape[f"{b}x{t}"] = row
    b, t = CMVN_BATCH, CMVN_BUCKETS[-1]
    return dict(name="sliding_cmvn", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/sliding_cmvn.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/cmvn.py:29 "
                         "(sliding_cmvn, XLA)",
                max_abs_err=max(err_host, err_plain), max_abs_err_vs_host_float64=err_host,
                max_abs_err_vs_plain_float64=err_plain, tolerance=TOL_CMVN, dtype="float32",
                checked_shapes=[[b_, t_, FEAT_DIM] for b_, t_ in shapes], checked_flags=CMVN_FLAGS,
                past_n=CMVN_PAST_N, reruns_bit_equal=True,
                per=f"one ({b}, {t}, {FEAT_DIM}) batch, centred, window 300",
                ms=timed["ms"], device_ms=timed["device_ms"], plain_ms=timed["plain_ms"],
                plain_device_ms=timed["plain_device_ms"], bound_ms=timed["bound_ms"],
                bound_by=timed["bound_by"], device_ms_norm_vars=timed["device_ms_norm_vars"],
                by_shape=by_shape, library_ms=None,
                library_note="none: no single PyTorch call computes a sliding-window "
                             "mean over time")


# K8 / K8b (attentive pooling) at the attentive paths' shapes (B, C, T, W):
# res2net200_att's serving head (B = 128 x 1000 frames, masked) and training
# microbatch (the encoders phase's, 200 frames), ECAPA-512's training head
# at W = 1, and a ragged case (C = 20, T = 1); stated tolerances as TOL_FP32
# and TOL_TRAIN_BF16 (bf16 kernel vs the plain version on the same inputs)
ATT_SHAPES = {"res2net200_att_serving": ((BATCH, 1024, 125, 10), True),
              "res2net200_att_training": ((128, 1024, 25, 10), False),
              "ecapa512_training": ((256, 1536, 200, 1), False),
              "ragged_c20_t1": ((4, 20, 1, 3), False)}
# K3 / K5 at channel counts that are not multiples of 4, and at dpn68's
# stem shape (B = 256 x 200 frames x 80 bins, C = 10): each takes the design
# its plan gives it (bn_act_plan, bn_train_plan at groups 1 and 8): the
# folded rows at the stem, at (64, 10, 25, 10) (K5; K3 in float32) and
# wherever n % fold == 0 (and F % fold == 0 for K3), the multi-kernel design
# or single channels elsewhere, such as (16, 10, 9, 5) at groups 8 in bf16
ANY_C = (1, 3, 10)
DPN_STEM = (256, 10, 200, 80)
# the designs these shapes must take (shape, dtype, K3's, K5's at groups 8)
ANY_C_DESIGNS = {(DPN_STEM, "bfloat16"): ("fold", "fold"), (DPN_STEM, "float32"): ("fold", "fold"),
                 ((64, 10, 25, 10), "bfloat16"): ("single", "fold"),
                 ((16, 10, 9, 5), "bfloat16"): ("single", "multi")}


def att_inputs(gen, shape, masked, dtype, dev):
    b, c, t, w = shape
    x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
    s = torch.randn(shape, generator=gen, device=dev) * 3
    mask = None
    if masked:
        mask = lengths_mask(gen, b, t, dev)
        mask[-1] = 0.0  # a row masked throughout (extraction's padding rows)
        x = x * mask[:, None, :, None]
    return _layout(x.to(dtype)), _layout(s.to(dtype)), mask


def check_att_pool(dev, gen):
    """K8 and K8b at ATT_SHAPES in float32 (against autograd of the plain
    version in float64: no further from it than twice the float32 plain
    version, or TOL_FP32; where a column's weights peak on a few frames, q -
    mean^2 cancels in any float32 computation) and bfloat16 (against the
    plain version in float32, TOL_TRAIN_BF16); one launch a direction a call; reruns bit for bit; a
    row masked throughout (the plain mean over T) and a row of constant x
    and scores (q - mean^2 == 0: dx = dmean / T, ds = 0); device times of
    both kernels and of the plain version, and bounds, at every shape.
    Returns the K8 and K8b rows."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    def run(fn, x, s, mask, dout):
        xi, si = x.detach().clone().requires_grad_(True), s.detach().clone().requires_grad_(True)
        y = fn(xi, si, mask)
        y.backward(dout)
        return y.detach(), xi.grad, si.grad

    errs = {"fwd": {}, "bwd": {}, "plain_fp32_vs_float64": {}}
    by_shape = {}
    for name, (shape, masked) in ATT_SHAPES.items():
        b, c, t, w = shape
        for dtype in (torch.float32, torch.bfloat16):
            x, s, mask = att_inputs(gen, shape, masked, dtype, dev)
            dout = _layout(torch.randn((b, 2 * c, 1, w), generator=gen, device=dev).to(dtype))
            before = dict(kernels.ATT_POOL.fn_launches)
            got = run(ops.att_pool, x, s, mask, dout)
            launched = {f: n - before[f] for f, n in kernels.ATT_POOL.fn_launches.items()}
            if launched != {"att_pool_fwd": 1, "att_pool_bwd": 1}:
                fail(f"att_pool {name}: launched {launched}")
            # float32 against the plain version in float64 (two float32
            # computations of dx cancel differently where std is small
            # against |mean|), bf16 against the float32 one
            key = f"{name}_{str(dtype).split('.')[-1]}"
            if dtype == torch.float32:
                want = run(ops.att_pool_reference, x.double(), s.double(), mask, dout.double())
                plain = [rel_err(a, r) for a, r in
                         zip(run(ops.att_pool_reference, x, s, mask, dout), want)]
                errs["plain_fp32_vs_float64"][name] = plain
                tols = [max(TOL_FP32, 2 * e) for e in plain]
            else:
                want = run(ops.att_pool_reference, x, s, mask, dout)
                tols = [TOL_TRAIN_BF16] * 3
            e = [rel_err(a, r) for a, r in zip(got, want)]
            errs["fwd"][key], errs["bwd"][key] = e[0], max(e[1:])
            if any(a > t for a, t in zip(e, tols)):
                fail(f"att_pool {key}: rel err (out, dx, ds) {e} against {tols}")
            if not all(torch.equal(a, r) for a, r in zip(got, run(ops.att_pool, x, s, mask, dout))):
                fail(f"att_pool {key}: two runs on the same inputs differ")
            if masked and dtype == torch.float32:
                if not torch.allclose(got[0][-1, :c, 0], x[-1].float().mean(dim=1), atol=1e-5) \
                        or not torch.all(got[2][-1] == 0):
                    fail(f"att_pool {name}: the row masked throughout is not the plain mean")
            del got, want
        xb, sb, mask = att_inputs(gen, shape, masked, torch.bfloat16, dev)
        db = _layout(torch.randn((b, 2 * c, 1, w), generator=gen, device=dev).bfloat16())
        xi, si = xb.detach().requires_grad_(True), sb.detach().requires_grad_(True)
        y = ops.att_pool(xi, si, mask)
        nel, out = xb.numel(), b * 2 * c * w
        # forward: x and s read once, the pooled rows written (the mask,
        # B x T floats, is noise); backward: x, s and dout read, dx and ds
        # written; ~12 and ~16 float32 operations (one exp) an element
        bfwd = bound_ms(2 * (2 * nel + out), 12.0 * nel, torch.float32)
        bbwd = bound_ms(2 * (4 * nel + out), 16.0 * nel, torch.float32)
        row = dict(shape=list(shape), masked=masked,
                   device_ms=device_ms(lambda: ops.att_pool(xb, sb, mask), "att_pool_fwd_kernel"),
                   device_ms_bwd=device_ms(lambda: torch.autograd.grad(y, [xi, si], db,
                                                                       retain_graph=True),
                                           "att_pool_bwd_kernel"),
                   plain_device_ms=device_ms(lambda: ops.att_pool_reference(xb, sb, mask)),
                   bound_ms=bfwd[0], bound_by=bfwd[1], bound_ms_bwd=bbwd[0],
                   bound_by_bwd=bbwd[1])
        fwd, bwd = time_fwd_bwd(lambda a, z: ops.att_pool(a, z, mask), [xb, sb], db)
        pfwd, pbwd = time_fwd_bwd(lambda a, z: ops.att_pool_reference(a, z, mask), [xb, sb], db)
        row.update(ms=fwd, ms_bwd=bwd, plain_ms=pfwd, plain_ms_bwd=pbwd)
        xi2, si2 = xb.detach().requires_grad_(True), sb.detach().requires_grad_(True)
        y2 = ops.att_pool_reference(xi2, si2, mask)
        row["plain_device_ms_bwd"] = device_ms(lambda: torch.autograd.grad(
            y2, [xi2, si2], db, retain_graph=True))
        by_shape[name] = row
        del xb, sb, db, xi, si, y, xi2, si2, y2
        torch.cuda.empty_cache()
    # a row of constant x and scores: q - mean^2 == 0 exactly
    x, s, _ = att_inputs(gen, (2, 16, 8, 3), False, torch.float32, dev)
    x[0], s[0] = 2.0, 0.75
    dout = _layout(torch.randn((2, 32, 1, 3), generator=gen, device=dev))
    _, dx, ds = run(ops.att_pool, x, s, None, dout)
    if not torch.allclose(dx[0], (dout[0, :16] / 8).expand(16, 8, 3), atol=1e-6) \
            or float(ds[0].abs().max()) > 1e-6:
        fail("att_pool: the constant row's gradient is not dmean / T, ds 0")
    emit({"phase": "kernel", "name": "att_pool", "errors": errs, "by_shape": by_shape})
    common = dict(route="cuda", source="voxsrc2020_speaker_verification_tpu_torch/csrc/att_pool.cu",
                  tolerance={"float32": "max(TOL_FP32, 2 x the float32 plain version's "
                                        "distance to float64)", "bfloat16": TOL_TRAIN_BF16},
                  reruns_bit_equal=True, dtype="bfloat16", library_ms=None,
                  library_note="none: no single PyTorch call computes a masked softmax "
                               "over time with the weighted mean and std",
                  edges="a row masked throughout, a row of constant x (q - mean^2 == 0), "
                        "T = 1, C = 20", by_shape=by_shape)
    serve = by_shape["res2net200_att_serving"]
    train = by_shape["res2net200_att_training"]
    k8 = dict(name="att_pool", replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:530 "
                                       "(AttStatsPool: masked softmax over T, weighted mean || "
                                       "std, XLA)",
              max_abs_err=max(errs["fwd"].values()), errors=errs["fwd"],
              per=f"res2net200_att serving head {ATT_SHAPES['res2net200_att_serving'][0]}",
              ms=serve["ms"], device_ms=serve["device_ms"], plain_ms=serve["plain_ms"],
              plain_device_ms=serve["plain_device_ms"], bound_ms=serve["bound_ms"],
              bound_by=serve["bound_by"], **common)
    k8b = dict(name="att_pool_bwd", replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:530 "
                                            "(AttStatsPool backward, JAX autodiff, XLA)",
               max_abs_err=max(errs["bwd"].values()), errors=errs["bwd"],
               per=f"res2net200_att training microbatch {ATT_SHAPES['res2net200_att_training'][0]}",
               ms=train["ms_bwd"], device_ms=train["device_ms_bwd"], plain_ms=train["plain_ms_bwd"],
               plain_device_ms=train["plain_device_ms_bwd"], bound_ms=train["bound_ms_bwd"],
               bound_by=train["bound_by_bwd"], **common)
    return k8, k8b


# K4 / K4b's column design (T past the 128-row ring): the W = 1 heads of
# TDNN (training, B = 1024 x 320 frames) and ECAPA-512 (training, 256 x 200;
# the attention's [mean; std] input), and an extraction bucket (1000 frames,
# lengths masked); 1536 channels, bf16
POOL_W1_SHAPES = (("tdnn", (1024, 1536, 320, 1), False), ("ecapa512", (256, 1536, 200, 1), False),
                  ("extract1000", (128, 1536, 1000, 1), True))


def check_stats_pool_w1(dev, gen):
    """K4 and K4b at the W = 1 shapes (POOL_W1_SHAPES), on their column
    design: output and input gradient against the plain version and its
    autograd (bf16 at each shape, float32 at ECAPA's), reruns bit for bit,
    device time, bound, and torch.var_mean and its autograd beside them.
    Returns the kernels line's two rows (launches filled in by main)."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    fwd, bwd = {}, {}
    for name, shape, masked in POOL_W1_SHAPES:
        b, c, t, w = shape
        mask = lengths_mask(gen, b, t, dev) if masked else None
        x = _layout(torch.randn(shape, generator=gen, device=dev) * 2 + 1).bfloat16()
        dout = _layout(torch.randn((b, 2 * c, 1, w), generator=gen, device=dev)).bfloat16()
        plan = ops.stats_pool_plan(b, t, w, c, torch.bfloat16)
        if plan["design"] != "column" or plan["x_reads"] != 1:
            fail(f"stats_pool at {shape}: plan {plan}, not the column design")
        errs, errs_grad = {}, {}
        for dtype in (torch.bfloat16,) + ((torch.float32,) if name == "ecapa512" else ()):
            xd, dd = x.to(dtype), dout.to(dtype)
            got, again, want = (pool_grad(fn, xd, mask, dd) for fn in (
                ops.stats_pool, ops.stats_pool, ops.stats_pool_reference))
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                fail(f"stats_pool at {shape}: two {dtype} runs on the same inputs differ")
            errs[str(dtype)], errs_grad[str(dtype)] = rel_err(got[0], want[0]), rel_err(got[1],
                                                                                       want[1])
            tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16["stats_pool"]
            if errs[str(dtype)] > tol or errs_grad[str(dtype)] > tol:
                fail(f"stats_pool at {shape} {dtype}: rel err {errs[str(dtype)]}, "
                     f"grad {errs_grad[str(dtype)]}")
            del got, again, want, xd, dd
        mbytes = 0 if mask is None else 4 * b * t
        xi = x.detach().requires_grad_(True)
        y = ops.stats_pool(xi, mask)
        common = dict(shape=list(shape), masked=masked, plan=plan)
        fwd[name] = dict(
            common, max_rel_err=errs,
            ms=time_ms(lambda: ops.stats_pool(x, mask), reps=20),
            device_ms=device_ms(lambda: ops.stats_pool(x, mask), "stats_pool_kernel"),
            plain_ms=time_ms(lambda: ops.stats_pool_reference(x, mask), reps=20),
            plain_device_ms=device_ms(lambda: ops.stats_pool_reference(x, mask)),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                2 * x.numel() + mbytes + 2 * b * 2 * c * w, 3.0 * x.numel(), torch.bfloat16))),
            library_ms=time_ms(var_mean_call(x, backward=False), reps=20),
            library_device_ms=device_ms(var_mean_call(x, backward=False)))
        bwd[name] = dict(
            common, max_rel_err=errs_grad,
            ms=time_ms(lambda: torch.autograd.grad(y, [xi], dout, retain_graph=True), reps=20),
            device_ms=device_ms(lambda: torch.autograd.grad(y, [xi], dout, retain_graph=True),
                                "stats_pool_bwd_kernel"),
            plain_ms=time_fwd_bwd(lambda v: ops.stats_pool_reference(v, mask), [x], dout)[1],
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                2 * 2 * x.numel() + mbytes + 2 * dout.numel(), 6.0 * x.numel(), torch.bfloat16))),
            library_ms=time_ms(var_mean_call(x, backward=True), reps=20),
            library_device_ms=device_ms(var_mean_call(x, backward=True)))
        del x, xi, y, dout, mask
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "stats_pool_w1", "fwd": fwd, "bwd": bwd})
    rows, bf16, fp32 = [], str(torch.bfloat16), str(torch.float32)
    for kname, by, src, what in (
            ("stats_pool:column", fwd, "stats_pool.cu", "stats_pool"),
            ("stats_pool_bwd:column", bwd, "stats_pool_bwd.cu",
             "stats_pool backward, JAX autodiff")):
        head = by["tdnn"]
        rows.append(dict(
            name=kname, route="cuda",
            source=f"voxsrc2020_speaker_verification_tpu_torch/csrc/{src}",
            replaces=f"voxsrc2020_speaker_verification_tpu/ops/nn.py:487 ({what}, XLA) at "
                     "W = 1, T > 128: the TDNN and ECAPA heads",
            max_abs_err=max(r["max_rel_err"][bf16] for r in by.values()),
            max_abs_err_is="bfloat16, relative to the plain version's largest magnitude",
            max_rel_err_bf16=max(r["max_rel_err"][bf16] for r in by.values()),
            tolerance=TOL_BF16["stats_pool"],
            max_rel_err_fp32=max(r["max_rel_err"][fp32] for r in by.values()
                                 if fp32 in r["max_rel_err"]),
            tolerance_fp32=TOL_FP32, dtype="bfloat16",
            per=f"one call at TDNN's head {tuple(head['shape'])}; by_shape: every W = 1 shape",
            ms=head["ms"], device_ms=head["device_ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
            library_device_ms=head["library_device_ms"],
            library_call="torch.var_mean over T" + (" and its autograd" if "bwd" in kname
                                                    else "") + ", no mask",
            by_shape=by, reruns_bit_equal=True))
    return rows


def pool_grad(fn, x, mask, dout):
    """(output, input gradient) of the stats pool ``fn`` at x."""
    xi = x.detach().requires_grad_(True)
    y = fn(xi, mask)
    y.backward(dout)
    return y.detach(), xi.grad


def bn_designs(shape, dtype, groups):
    """(K3's path, K5's design) for one shape: "vec" / "fold" / "single",
    and "fold" (the cluster design on folded rows), "cluster" or "multi"."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    plan = ops.bn_train_plan(tuple(shape), groups, dtype, 0, True)
    k5 = "fold" if plan["design"] == "cluster" and plan["fold"] > 1 else plan["design"]
    return ops.bn_act_plan(tuple(shape), dtype)["design"], k5


def check_bn_any_c(dev, gen):
    """K3 and K5 at ANY_C channels and at DPN_STEM against the plain
    versions in float32 and bfloat16, on the design each plan gives them
    (ANY_C_DESIGNS: the folded rows and the multi-kernel / single-channel
    paths): K3 with its flags, K5 forward, running update and backward under
    relu, groups 1 and 8; reruns bit for bit; at the stem (bf16) each
    direction's device time beside its bound and F.batch_norm's time.
    Returns a dict for the bn_act and bn_train rows and the rows of the
    folded designs (``bn_act:fold``, ``bn_train:fold``)."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops
    import torch.nn.functional as F

    shapes = [(16, c, 9, 5) for c in ANY_C] + [(64, c, 25, 10) for c in ANY_C] + [DPN_STEM]
    errs = {"bn_act": 0.0, "bn_train": 0.0, "bn_train_grad": 0.0}
    # the folded designs' own errors (bf16 and float32), for their rows
    fold_errs = {"bn_act": {}, "bn_train": {}}
    designs = {}
    flips = 0
    for shape in shapes:
        c, t = shape[1], shape[2]
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            tol = TOL_FP32 if dtype == torch.float32 else TOL_TRAIN_BF16
            k3_design, _ = bn_designs(shape, dtype, 8)
            designs[f"{shape}/{dn}"] = {"bn_act": k3_design, **{
                f"bn_train_g{g}": bn_designs(shape, dtype, g)[1] for g in (1, 8)}}
            want = ANY_C_DESIGNS.get((shape, dn))
            if want and (k3_design, designs[f"{shape}/{dn}"]["bn_train_g8"]) != want:
                fail(f"bn_any_c: {shape} {dn} takes {designs[f'{shape}/{dn}']}, not {want}")
            x = _layout((torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(dtype))
            sc = _layout(torch.randn(shape, generator=gen, device=dev).to(dtype))
            dy = _layout(torch.randn(shape, generator=gen, device=dev).to(dtype))
            m, v = 0.1 * torch.randn(c, generator=gen, device=dev), 0.5 + torch.rand(c, generator=gen, device=dev)
            mask = lengths_mask(gen, shape[0], t, dev)
            for kw in (dict(relu=True, mask=mask), dict(shortcut=sc),
                       dict(relu=True, shortcut=sc, shortcut_mean=m, shortcut_var=v)):
                got = ops.bn_act(x, m, v, **kw)
                e = rel_err(got, ops.bn_act_reference(x, m, v, **kw))
                errs["bn_act"] = max(errs["bn_act"], e)
                if k3_design == "fold":
                    fold_errs["bn_act"][dn] = max(fold_errs["bn_act"].get(dn, 0.0), e)
                if e > tol or not torch.equal(got, ops.bn_act(x, m, v, **kw)):
                    fail(f"bn_act at {shape} {dtype}: rel err {e} or reruns differ")
            for groups in (1, 8):
                runs = []
                for fn in (ops.bn_train, ops.bn_train_reference, ops.bn_train):
                    xi, st = x.detach().clone().requires_grad_(True), [m.clone(), v.clone()]
                    y = fn(xi, st[0], st[1], groups=groups, relu=True)
                    y.backward(dy)
                    runs.append((y.detach(), xi.grad, *st))
                (y, dx, rm, rv), (yr, dxr, rmr, rvr), again = runs
                same = (y > 0) == (yr > 0)
                flips = max(flips, int((~same).sum()))
                ey = max(rel_err(y, yr), rel_err(rm, rmr), rel_err(rv, rvr))
                eg = rel_err(dx * same, dxr * same)
                errs["bn_train"] = max(errs["bn_train"], ey)
                errs["bn_train_grad"] = max(errs["bn_train_grad"], eg)
                if designs[f"{shape}/{dn}"][f"bn_train_g{groups}"] == "fold":
                    fold_errs["bn_train"][dn] = max(fold_errs["bn_train"].get(dn, 0.0), ey)
                    fold_errs["bn_train"][dn + "_grad"] = max(
                        fold_errs["bn_train"].get(dn + "_grad", 0.0), eg)
                gtol = TOL_K5_GRAD_FP32 if dtype == torch.float32 else TOL_TRAIN_BF16
                if ey > tol or eg > gtol or flips > 1:
                    fail(f"bn_train at {shape} g{groups} {dtype}: rel err {ey}, grad {eg}, "
                         f"relu flips {flips}")
                if not all(torch.equal(a, b) for a, b in zip(runs[0], again)):
                    fail(f"bn_train at {shape} g{groups} {dtype}: two runs differ")
                del runs
        del x, sc, dy
        torch.cuda.empty_cache()
    # at dpn68's stem (bf16): K3 with relu and mask (eval), K5 forward and
    # backward under relu, bn_groups 8; F.batch_norm in eval mode, and in
    # training mode at one group (forward, backward)
    x = _layout(torch.randn(DPN_STEM, generator=gen, device=dev).bfloat16())
    dy = _layout(torch.randn(DPN_STEM, generator=gen, device=dev).bfloat16())
    m, v = torch.zeros(10, device=dev), torch.ones(10, device=dev)
    mask = lengths_mask(gen, DPN_STEM[0], DPN_STEM[2], dev)
    xi = x.detach().requires_grad_(True)
    y = ops.bn_train(xi, m.clone(), v.clone(), groups=8, relu=True)
    yr = ops.bn_train_reference(xi, m.clone(), v.clone(), groups=8, relu=True)
    li = x.detach().requires_grad_(True)
    ly = F.batch_norm(li, m.clone(), v.clone(), training=True, momentum=1 - ops.BN_MOMENTUM,
                      eps=ops.BN_EPSILON)

    def k5_fwd():
        with torch.no_grad():
            return ops.bn_train(x, m.clone(), v.clone(), groups=8, relu=True)

    def lib_fwd():
        with torch.no_grad():
            return F.batch_norm(x, m.clone(), v.clone(), training=True,
                                momentum=1 - ops.BN_MOMENTUM, eps=ops.BN_EPSILON)

    nel = x.numel()
    k3 = lambda: ops.bn_act(x, m, v, relu=True, mask=mask)  # noqa: E731
    k3_plain = lambda: ops.bn_act_reference(x, m, v, relu=True, mask=mask)  # noqa: E731
    k3_lib = lambda: F.batch_norm(x, m, v, eps=ops.BN_EPSILON)  # noqa: E731
    k5_bwd = lambda: torch.autograd.grad(y, [xi], dy, retain_graph=True)  # noqa: E731
    plain_bwd = lambda: torch.autograd.grad(yr, [xi], dy, retain_graph=True)  # noqa: E731
    lib_bwd = lambda: torch.autograd.grad(ly, [li], dy, retain_graph=True)  # noqa: E731
    stem = dict(shape=list(DPN_STEM), dtype="bfloat16", groups=8,
                designs=designs[f"{DPN_STEM}/bfloat16"],
                bn_act_ms=time_ms(k3, reps=20), bn_act_device_ms=device_ms(k3, "bn_act"),
                bn_act_plain_ms=time_ms(k3_plain, reps=20),
                bn_act_plain_device_ms=device_ms(k3_plain),
                bn_act_bound_ms=bound_ms(2 * 2 * nel + 4 * DPN_STEM[0] * DPN_STEM[2], 0.0,
                                         torch.bfloat16)[0],
                bn_act_library_ms=time_ms(k3_lib, reps=20),
                bn_act_library_device_ms=device_ms(k3_lib),
                bn_train_fwd_ms=time_ms(k5_fwd, reps=20), bn_train_bwd_ms=time_ms(k5_bwd, reps=20),
                bn_train_fwd_device_ms=device_ms(k5_fwd, "cluster_fwd_kernel"),
                bn_train_bwd_device_ms=device_ms(k5_bwd, "cluster_bwd_kernel"),
                bn_train_fwd_call_device_ms=device_ms(k5_fwd),
                bn_train_bwd_call_device_ms=device_ms(k5_bwd),
                bn_train_plain_fwd_ms=time_ms(lambda: ops.bn_train_reference(
                    x, m.clone(), v.clone(), groups=8, relu=True), reps=20),
                bn_train_plain_bwd_ms=time_ms(plain_bwd, reps=20),
                # x read, y written; x, dy read, dx written
                bn_train_fwd_bound_ms=bound_ms(2 * 2 * nel, 8.0 * nel, torch.float32)[0],
                bn_train_bwd_bound_ms=bound_ms(3 * 2 * nel, 12.0 * nel, torch.float32)[0],
                library_fwd_ms=time_ms(lib_fwd, reps=20), library_bwd_ms=time_ms(lib_bwd, reps=20),
                library_fwd_device_ms=device_ms(lib_fwd), library_bwd_device_ms=device_ms(lib_bwd))
    del x, dy, xi, y, yr, li, ly
    torch.cuda.empty_cache()
    out = dict(channels=list(ANY_C), shapes=[list(sh) for sh in shapes], designs=designs,
               max_rel_err=errs, max_relu_flips=flips, reruns_bit_equal=True, dpn_stem=stem)
    emit({"phase": "kernel", "name": "bn_any_channel_count", **out})
    src = "voxsrc2020_speaker_verification_tpu_torch/csrc/"
    common = dict(route="cuda", dtype="bfloat16", reruns_bit_equal=True,
                  per=f"one call at dpn68's stem {DPN_STEM}, bn_groups 8",
                  max_abs_err_is="bfloat16, relative to the plain version's largest magnitude")
    rows = [
        dict(common, name="bn_act:fold", source=src + "bn_epilogue.cu",
             replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:206 (BatchNorm eval "
                      "branch + relu/mask_time, XLA) at C % 4 != 0: dpn68's 10-channel calls",
             max_abs_err=fold_errs["bn_act"]["bfloat16"],
             max_rel_err_fp32=fold_errs["bn_act"]["float32"], tolerance=TOL_TRAIN_BF16,
             tolerance_fp32=TOL_FP32, ms=stem["bn_act_ms"], device_ms=stem["bn_act_device_ms"],
             plain_ms=stem["bn_act_plain_ms"], plain_device_ms=stem["bn_act_plain_device_ms"],
             bound_ms=stem["bn_act_bound_ms"], bound_by="bytes",
             library_ms=stem["bn_act_library_ms"],
             library_device_ms=stem["bn_act_library_device_ms"],
             library_call="F.batch_norm, eval mode (no relu, no mask)"),
        dict(common, name="bn_train:fold", source=src + "bn_train.cu",
             replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:117 (_GroupedBN + relu, "
                      "XLA, forward and backward) at C % vec != 0: dpn68's 10-channel calls",
             max_abs_err=fold_errs["bn_train"]["bfloat16"],
             max_rel_err_fp32=fold_errs["bn_train"]["float32"],
             max_rel_err_fp32_grad=fold_errs["bn_train"]["float32_grad"],
             tolerance=TOL_TRAIN_BF16, tolerance_fp32=TOL_FP32,
             tolerance_fp32_grad=TOL_K5_GRAD_FP32,
             ms=stem["bn_train_fwd_ms"] + stem["bn_train_bwd_ms"],
             device_ms=stem["bn_train_fwd_device_ms"] + stem["bn_train_bwd_device_ms"],
             device_ms_fwd=stem["bn_train_fwd_device_ms"],
             device_ms_bwd=stem["bn_train_bwd_device_ms"],
             plain_ms=stem["bn_train_plain_fwd_ms"] + stem["bn_train_plain_bwd_ms"],
             bound_ms=stem["bn_train_fwd_bound_ms"] + stem["bn_train_bwd_bound_ms"],
             bound_ms_fwd=stem["bn_train_fwd_bound_ms"],
             bound_ms_bwd=stem["bn_train_bwd_bound_ms"], bound_by="bytes",
             library_ms=stem["library_fwd_ms"] + stem["library_bwd_ms"],
             library_device_ms=stem["library_fwd_device_ms"] + stem["library_bwd_device_ms"],
             library_call="F.batch_norm, training mode at one group, forward + backward "
                          "(no relu)")]
    return out, rows


# ----------------------------------------------------------------------
# phases 5-7: the training step, its CPU parity, and serving what it trained
# ----------------------------------------------------------------------

def train_phase(dev, per_microbatch, smi):
    from voxsrc2020_speaker_verification_tpu_torch import kernels, set_float32_precision
    from voxsrc2020_speaker_verification_tpu_torch.data.dataset import (
        BatchFeeder, SyntheticDataset)
    from voxsrc2020_speaker_verification_tpu_torch.losses import schedules
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe
    from voxsrc2020_speaker_verification_tpu_torch.training.loop import fit
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        create_train_state, make_train_step, schedule_values)

    config, _ = get_recipe("res2net_vox2_dev_aug", model=TRAIN_MODEL, batch_size=TRAIN_BATCH,
                           num_accumulation_steps=TRAIN_ACCUM, feat_length=TRAIN_FRAMES,
                           seed=SEED)
    if (config.bn_groups, config.bf16, config.num_classes) != (TRAIN_GROUPS, True, 5994):
        fail(f"train config is not the bench shape: {config}")
    state = create_train_state(config, dev)
    feeder = BatchFeeder([SyntheticDataset(config.feat_dim, config.feat_length,
                                           config.num_classes, seed=SEED + i) for i in range(4)],
                         config.batch_size, config.num_accumulation_steps).start()
    lines = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rn.reset_split_train_routes()
        s2_before = rn.split_stride2_route_counts()
        result = fit(config, feeder, log_every=1, log_fn=lines.append, max_steps=TRAIN_STEPS,
                     checkpoint=False, device=dev, state=state)
        counts = kernels.function_launch_counts()
        routes = rn.split_train_route_counts()
        s2_routes = {k: v - s2_before[k] for k, v in rn.split_stride2_route_counts().items()}
    finally:
        feeder.stop()
    peak = torch.cuda.max_memory_allocated()
    hist = result.history
    if len(hist) != TRAIN_STEPS:
        fail(f"train: {len(hist)} logged steps")
    for h in hist:
        lr, margin = schedule_values(config, h["step"] - 1)
        if not math.isfinite(h["loss"]):
            fail(f"train: non-finite loss at step {h['step']}")
        total = float(schedules.total_margin(config.projection, margin))
        if h["learning_rate"] != lr or h["margin"] != total:
            fail(f"train: step {h['step']} lr {h['learning_rate']} margin {h['margin']}, "
                 f"schedules say {lr}, {total}")
    steps = TRAIN_STEPS * config.num_accumulation_steps
    for fn, n in per_microbatch.items():
        if counts[fn] != steps * n:
            fail(f"train: {fn} launched {counts[fn]} times, expected {steps} x {n}")
    for fn in EVAL_KERNEL_FNS:
        if counts[fn]:
            fail(f"train: eval kernel {fn} launched {counts[fn]} times")
    # every stride-1 chain on K9 / K9b: none through F.conv2d (the span or
    # the plain route)
    chains = per_microbatch["split_train.split_train_finish"]
    if routes != {"kernels": steps * chains, "span": 0, "plain": 0}:
        fail(f"train: split chain routes {routes}, expected {steps} x {chains} on the kernels")
    # every stride-2 stage on K11 / K11b: none through the route
    stages2 = per_microbatch["split_stride2_train.split_stride2_train_bwd_grad"]
    if s2_routes != {"kernel": 0, "plain": 0, "train_kernels": steps * stages2,
                     "train_plain": 0, "span": 0}:
        fail(f"train: stride-2 routes {s2_routes}, expected {steps} x {stages2} on K11 / K11b")
    step_s = [b["time"] - a["time"] for a, b in zip(hist, hist[1:])]
    med = statistics.median(step_s)
    # the bf16 step, resident, with cuDNN's and cuBLAS's TF32 off (the CLIs'
    # precision rule) and on (PyTorch's default, which the CLIs kept before
    # it), in turns: off, on, on, off, two steps each
    step = make_train_step(config)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    feats = torch.randn((TRAIN_ACCUM, TRAIN_BATCH, TRAIN_FRAMES, FEAT_DIM), generator=gen,
                        device=dev)
    labels = torch.randint(0, config.num_classes, (TRAIN_ACCUM, TRAIN_BATCH), generator=gen,
                           device=dev)
    state = result.state
    tf32_ms = {"off": [], "on": []}
    try:
        for mode in ("off", "on", "on", "off"):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = mode == "on"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                state, _ = step(state, feats, labels)
            torch.cuda.synchronize()
            tf32_ms[mode].append(1e3 * (time.perf_counter() - t0) / 2)
    finally:
        set_float32_precision()
    emit({"phase": "train", "model": TRAIN_MODEL, "dtype": "bfloat16", "batch": TRAIN_BATCH,
          "resident_step_ms_tf32_off": tf32_ms["off"], "resident_step_ms_tf32_on": tf32_ms["on"],
          "accumulation": TRAIN_ACCUM, "frames": TRAIN_FRAMES, "bn_groups": config.bn_groups,
          "steps": TRAIN_STEPS, "timed_steps": len(step_s), "step_ms": [1e3 * s for s in step_s],
          "step_ms_median": 1e3 * med,
          "audio_s_per_s": config.effective_batch * config.feat_length / 100.0 / med,
          "peak_memory_bytes": peak, "losses": [h["loss"] for h in hist],
          "learning_rates": [h["learning_rate"] for h in hist],
          "margins": [h["margin"] for h in hist], "launches": counts,
          "launches_per_microbatch": per_microbatch, "split_chain_routes": routes,
          "stride2_routes": s2_routes, "log": lines, "card": smi})
    return state, config, counts


def train_parity_phase(dev, model=TRAIN_MODEL, batch=16, hard=True):
    """One float32 step on the card against the CPU (float32 and float64),
    held to TOL_PARITY; with ``hard`` False the result is printed on a line
    of its own (``thin_parity_printed``) and nothing fails."""
    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        create_train_state, make_train_step, schedule_values)

    config = TrainConfig(model=model, bf16=False, batch_size=batch, num_accumulation_steps=1,
                         bn_groups=2, feat_length=TRAIN_FRAMES, seed=SEED)
    start = 4 * config.epoch_size  # constant LR, growing margin: both > 0
    lr, margin = schedule_values(config, start)
    rng = np.random.RandomState(SEED + 7)
    feats = torch.from_numpy(rng.randn(1, batch, TRAIN_FRAMES, FEAT_DIM).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, config.num_classes, (1, batch)))
    runs = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                          (torch.device("cpu"), torch.float64)):
        state = create_train_state(config, device, seed=SEED + 3)
        state.net.to(dtype)
        state.net.encoder.dtype = dtype
        state.momentum = {k: v.to(dtype) for k, v in state.momentum.items()}
        state.step = start
        before = {k: v.detach().cpu().double().clone() for k, v in state.params.items()}
        t0 = time.perf_counter()
        state, m = make_train_step(config)(state, feats.to(device), labels.to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
        update = torch.cat([(state.params[k].detach().cpu().double() - b).flatten()
                            for k, b in before.items()])
        stats = {k: v.detach().cpu().double() for k, v in state.batch_stats.items()}
        runs.append((update, stats, {k: float(v) for k, v in m.items()},
                     time.perf_counter() - t0))
    (ug, sg, mg, tg), (uc, sc, mc, tc), (u64, _, m64, t64) = runs

    def l2(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    errs = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in ("loss", "gradient_norm")}
    errs["update"] = l2(ug, uc)
    errs["batch_stats"] = max(float((sg[k] - v).abs().max() / v.abs().max().clamp(min=1e-3))
                              for k, v in sc.items())
    # the fp32 error of the update and of the gradient norm: each fp32 step
    # against the float64 one
    vs64 = {"update": {"gpu_fp32": l2(ug, u64), "cpu_fp32": l2(uc, u64)},
            "gradient_norm": {name: abs(m["gradient_norm"] - m64["gradient_norm"])
                              / m64["gradient_norm"] for name, m in (("gpu_fp32", mg),
                                                                     ("cpu_fp32", mc))}}
    if lr <= 0 or margin <= 0:
        fail("train_parity: the compared step must have lr > 0 and margin > 0")
    bad = {k: v for k, v in errs.items() if k in ("loss", "batch_stats") and not v <= TOL_PARITY[k]}
    for k, e in vs64.items():
        if not e["gpu_fp32"] <= 2 * e["cpu_fp32"] + TOL_PARITY[k]:
            bad[f"{k}_vs_float64"] = e
    emit({"phase": "train_parity" if hard else "thin_parity_printed", "model": model,
          "dtype": "float32", "batch": batch, "bn_groups": 2, "step": start,
          "learning_rate": lr, "margin": margin, "gpu": mg, "cpu": mc, "rel_err": errs,
          "rel_err_vs_float64": vs64, "tolerance": TOL_PARITY, "holds_tolerance": not bad,
          "hard_check": hard, "gpu_s": tg, "cpu_s": tc, "cpu_float64_s": t64})
    if bad and hard:
        fail(f"train_parity {model}: GPU vs CPU beyond tolerance: {bad}")


def fn_total(counts, fn):
    """Launches of C function ``fn`` over its paths (``fn:<path>`` keys)."""
    return sum(v for k, v in counts.items() if k == fn or k.startswith(fn + ":"))


def row_counts(row, counts):
    """The launch counts of a kernels-line row's C functions: those of its
    library (``library``, else its name), only ``functions`` where it names
    one direction of a library."""
    lib, fns = row.get("library", row["name"]), row.get("functions")
    return {k: v for k, v in counts.items() if k.split(".")[0] == lib
            and (fns is None or k.split(".")[1].split(":")[0] in fns)}


K5_LAUNCH_KEYS = ("bn_train.bn_cluster_fwd:row", "bn_train.bn_cluster_bwd:row",
                  "bn_train.bn_cluster_fwd:fold", "bn_train.bn_cluster_bwd:fold",
                  "bn_train.bn_head_fwd:vector", "bn_train.bn_head_bwd:vector",
                  "bn_train.bn_head_fwd:single", "bn_train.bn_head_bwd:single",
                  "bn_train.bn_train_fwd", "bn_train.bn_train_bwd")


def k5_functions(shape, groups, mode, relu):
    """(forward, backward) launch-count keys of one K5 call: the design
    bn_train_plan gives it at its real shape in bf16 (the cluster design on
    rows or on folded rows, the head design on the 2-D calls, or the
    multi-kernel design)."""
    from voxsrc2020_speaker_verification_tpu_torch.ops.nn import bn_train_plan

    plan = bn_train_plan(tuple(shape), groups, torch.bfloat16, mode, relu)
    if plan["design"] == "multi":
        return "bn_train.bn_train_fwd", "bn_train.bn_train_bwd"
    if plan["design"] == "head":
        return (f"bn_train.bn_head_fwd:{plan['lanes']}", f"bn_train.bn_head_bwd:{plan['lanes']}")
    path = "fold" if plan["fold"] > 1 else "row"
    return f"bn_train.bn_cluster_fwd:{path}", f"bn_train.bn_cluster_bwd:{path}"


def k5_launches(k5, groups, again=None) -> dict:
    """K5's launches per microbatch by C function and design for ``k5``'s
    calls (train_shapes: (shape, relu, mode) -> count), and the forward
    again for the rematerialized ``again``."""
    out = dict.fromkeys(K5_LAUNCH_KEYS, 0)
    for calls, both in ((k5, True), (again or {}, False)):
        for (shape, relu, mode), n in calls.items():
            fwd, bwd = k5_functions(shape, groups, mode, relu)
            out[fwd] += n
            out[bwd] += n if both else 0
    return out


def write_feature_store(root, dataset, seed):
    """The LMFT leg's data dir: LMFT_UTTS utterances of 600-1200 frames x
    80 bins with speakers over the recipe's 5994 classes, CM-compressed
    by the port's kaldi_io into one ark + scp, sharded into LMFT_SHARDS
    scps, and utt2id.pkl. Returns the seconds it took."""
    from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
    from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

    t0 = time.perf_counter()
    data_dir = os.path.join(root, dataset)
    os.makedirs(data_dir)
    rng = np.random.RandomState(seed)
    speakers = [f"id{i:05d}" for i in range(5994)]
    utt2spk = {}
    scp = os.path.join(data_dir, "feats.scp")
    with kaldi_io.ArkScpWriter(os.path.join(data_dir, "feats.ark"), scp, compress=True) as w:
        for i in range(LMFT_UTTS):
            spk = speakers[rng.randint(len(speakers))]
            utt = f"{spk}-{i:05d}"
            t = int(rng.randint(*LMFT_LENGTHS))
            # log-mel-like: a per-utterance spectral envelope plus noise
            feats = rng.randn(1, FEAT_DIM) * 2 + 8 + rng.randn(t, FEAT_DIM)
            w.write(utt, feats.astype(np.float32))
            utt2spk[utt] = spk
    datadir.save_utt2id(os.path.join(data_dir, "utt2id.pkl"),
                        datadir.build_utt2id(utt2spk, speakers))
    datadir.shard_scp(scp, LMFT_SHARDS)
    return time.perf_counter() - t0


def lmft_phase(dev, state, smi, workdir):
    """The LMFT leg through the train CLI from a feature store and the
    native feeder, resumed from phase 5's state; then remat vs no remat from
    one state and one batch (see the module docstring)."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
    from voxsrc2020_speaker_verification_tpu_torch.losses import schedules
    from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe
    from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import CheckpointManager
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        create_train_state, make_train_step, schedule_values)

    root, exp_root = os.path.join(workdir, "data"), os.path.join(workdir, "exp")
    overrides = dict(batch_size=TRAIN_BATCH, num_accumulation_steps=TRAIN_ACCUM,
                     bn_groups=LMFT_GROUPS, remat=True, remat_stages=LMFT_STAGES,
                     exp_root=exp_root, seed=SEED)
    config, resume_from = get_recipe("res2net_finetune_vox2_dev", model=TRAIN_MODEL, **overrides)
    if (config.feat_length, config.margin, config.num_classes) != (LMFT_FRAMES, 0.4, 5994):
        fail(f"lmft config is not the LMFT leg: {config}")
    store_s = write_feature_store(root, config.dataset, SEED + 21)
    # phase 5's trained state as the last checkpoint of the pretrain run:
    # its step is the end of pretraining, where the LMFT schedule starts
    pretrain, _ = get_recipe("res2net_vox2_dev_aug", model=TRAIN_MODEL, exp_root=exp_root)
    trained_step, resumed = state.step, pretrain.total_steps
    state.step = resumed
    CheckpointManager(pretrain.exp_dir).save(state)
    state.step = trained_step

    argv = ["--recipe", "res2net_finetune_vox2_dev", "--model", TRAIN_MODEL,
            "--data-root", root, "--exp-root", exp_root,
            "--batch-size", str(TRAIN_BATCH), "--num-accumulation-steps", str(TRAIN_ACCUM),
            "--bn-groups", str(LMFT_GROUPS), "--remat",
            "--remat-stages", *map(str, LMFT_STAGES), "--num-shards", str(LMFT_SHARDS),
            "--num-workers", "4", "--max-steps", str(LMFT_STEPS), "--log-every", "1",
            "--seed", str(SEED)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = train_cli.main(argv)
    torch.cuda.synchronize()
    counts = kernels.function_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = run.result.history
    if run.feeder != "native" or run.decode_errors != 0:
        fail(f"lmft: feeder {run.feeder}, {run.decode_errors} decode errors")
    if [h["step"] for h in hist] != [resumed + i + 1 for i in range(LMFT_STEPS)]:
        fail(f"lmft: steps {[h['step'] for h in hist]}, not a resume from step {resumed}")
    for h in hist:
        lr, margin = schedule_values(config, h["step"] - 1)
        total = float(schedules.total_margin(config.projection, margin))
        if not math.isfinite(h["loss"]) or margin != np.float32(0.4):
            fail(f"lmft: step {h['step']} loss {h['loss']}, scheduled margin {margin}")
        if h["learning_rate"] != lr or h["margin"] != total:
            fail(f"lmft: step {h['step']} lr {h['learning_rate']} margin {h['margin']}, "
                 f"schedules say {lr}, {total}")
    tcfg = RES2NET_CONFIGS[TRAIN_MODEL]
    k5, _ = train_shapes(tcfg, TRAIN_BATCH, LMFT_FRAMES, FEAT_DIM)
    k5_remat, _ = train_shapes(tcfg, TRAIN_BATCH, LMFT_FRAMES, FEAT_DIM, LMFT_STAGES)

    # the recompute of stages 0-2 (policy None) runs their chains' K9 and
    # their stride-2 stages' K11 again
    chains = k9_launches(train_chains(tcfg, TRAIN_BATCH, LMFT_FRAMES, FEAT_DIM),
                         train_chains(tcfg, TRAIN_BATCH, LMFT_FRAMES, FEAT_DIM, LMFT_STAGES))
    k11_again = train_stride2(tcfg, TRAIN_BATCH, LMFT_FRAMES, FEAT_DIM, LMFT_STAGES)
    stride2 = k11_launches(train_stride2(tcfg, TRAIN_BATCH, LMFT_FRAMES, FEAT_DIM), k11_again)
    per_microbatch = {**chains, **stride2, **k5_launches(k5, LMFT_GROUPS, k5_remat),
                      **K6_SLAB_PER_MICROBATCH, **POOL_RING_PER_MICROBATCH}
    microbatches = LMFT_STEPS * config.num_accumulation_steps
    for fn, n in per_microbatch.items():
        if counts[fn] != microbatches * n:
            fail(f"lmft: {fn} launched {counts[fn]} times, expected {microbatches} x {n}")
    step_s = [b["time"] - a["time"] for a, b in zip(hist, hist[1:])]
    med = statistics.median(step_s)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # remat vs no remat: one state, the same two B=64 f600 batches (A=1);
    # the second step is timed (the first grows the allocator's pool), a
    # third reads the device time under the profiler
    rng = np.random.RandomState(SEED + 23)
    batches = [(torch.from_numpy(rng.randn(1, LMFT_CHECK_BATCH, LMFT_FRAMES, FEAT_DIM)
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(rng.randint(0, 5994, (1, LMFT_CHECK_BATCH))).to(dev))
               for _ in range(2)]
    compare = {}
    for name, remat in (("remat", True), ("plain", False)):
        cfg = get_recipe("res2net_finetune_vox2_dev", model=TRAIN_MODEL,
                         batch_size=LMFT_CHECK_BATCH, num_accumulation_steps=1,
                         bn_groups=LMFT_CHECK_GROUPS, remat=remat,
                         remat_stages=LMFT_STAGES if remat else None, seed=SEED)[0]
        st = create_train_state(cfg, dev, seed=SEED + 5)
        st.step = resumed
        step = make_train_step(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st, m = step(st, *batches[0])
        first = {k: float(m[k]) for k in ("loss", "gradient_norm")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, *batches[1])
        torch.cuda.synchronize()
        compare[name] = dict(step_ms=1e3 * (time.perf_counter() - t0),
                             peak_memory_bytes=torch.cuda.max_memory_allocated(),
                             loss=[first["loss"], float(m["loss"])],
                             gradient_norm=[first["gradient_norm"], float(m["gradient_norm"])],
                             stats={k: v.detach().clone() for k, v in st.batch_stats.items()})
        compare[name].update(step_device_time(step, st, batches[1], compare[name]["step_ms"]))
        del st, step, m
    stats_equal = all(torch.equal(v, compare["plain"]["stats"][k])
                      for k, v in compare["remat"]["stats"].items())
    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(compare["remat"][k], compare["plain"][k]))
           for k in ("loss", "gradient_norm")}
    check_audio_s = LMFT_CHECK_BATCH * LMFT_FRAMES / 100.0
    for v in compare.values():
        del v["stats"]
        v["audio_s_per_s"] = check_audio_s / (v["step_ms"] / 1e3)
    emit({"phase": "lmft", "model": TRAIN_MODEL, "recipe": "res2net_finetune_vox2_dev",
          "dtype": "bfloat16", "batch": TRAIN_BATCH, "accumulation": TRAIN_ACCUM,
          "frames": LMFT_FRAMES, "bn_groups": LMFT_GROUPS, "remat_stages": list(LMFT_STAGES),
          "feeder": "native", "store": {"utterances": LMFT_UTTS, "frames": list(LMFT_LENGTHS),
                                        "shards": LMFT_SHARDS, "write_s": store_s},
          "resumed_from_step": resumed, "steps": LMFT_STEPS, "timed_steps": len(step_s),
          "step_ms": [1e3 * x for x in step_s], "step_ms_median": 1e3 * med,
          "audio_s_per_s": config.effective_batch * config.feat_length / 100.0 / med,
          "peak_memory_bytes": peak, "losses": [h["loss"] for h in hist],
          "learning_rates": [h["learning_rate"] for h in hist],
          "margins": [h["margin"] for h in hist], "launches": counts,
          "launches_per_microbatch": per_microbatch,
          "k11_reruns_per_microbatch": {"stages_rematerialized": sum(k11_again.values()),
                                        "split_stride2_train_fwd": sum(k11_again.values())},
          "remat_vs_plain": {"batch": LMFT_CHECK_BATCH, "accumulation": 1,
                             "bn_groups": LMFT_CHECK_GROUPS, "steps": 3, "timed": "the second",
                             "profiled": "the third (batch 2 again)",
                             **compare,
                             "batch_stats_bit_equal": stats_equal, "rel_err": rel,
                             "tolerance": {k: TOL_PARITY[k] for k in rel}},
          "card": smi})
    if not stats_equal:
        fail("lmft: BN statistics after a rematerialized step differ from the plain step's")
    bad = {k: v for k, v in rel.items() if not v <= TOL_PARITY[k]}
    if bad:
        fail(f"lmft: remat vs plain step beyond tolerance: {bad}")
    if not compare["remat"]["peak_memory_bytes"] < compare["plain"]["peak_memory_bytes"]:
        fail(f"lmft: remat peak memory {compare['remat']['peak_memory_bytes']} is not below "
             f"the plain step's {compare['plain']['peak_memory_bytes']}")
    return counts, per_microbatch, config.exp_dir


def step_device_time(step, state, batch, step_ms, names=()):
    """One more step under torch.profiler (device activity only): the wall
    time of that step, the device time of its kernels and copies (one
    stream, so their sum is the busy time), the device time of the kernels
    whose name holds each of ``names``, and the idle share of the
    unprofiled step, 1 - busy / ``step_ms``. None where the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and not e.key.startswith("Command Buffer")]
    busy = sum(e.device_time_total for e in events) / 1e3
    if busy <= 0:
        return {"profiled_step_ms": wall, "device_busy_ms": None, "device_idle_share": None}
    by_name = {n: sum(e.device_time_total for e in events if n in e.key) / 1e3 for n in names}
    return {"profiled_step_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / step_ms,
            **({"device_ms_by_kernel": by_name} if names else {})}


def write_raw_data(root, seed):
    """The raw phase's data dir: RAW_UTTS synthetic 16 kHz utterances of
    RAW_SECONDS (speech-like units of EVAL-style speaker banks), every
    RAW_SPEC_EVERY-th wav.scp entry a JSON spec (reverb by a synthetic RIR,
    background noise looped at 5-15 dB SNR) over wavs written beside them,
    and utt2id.pkl over the recipe's 5994 classes. Returns (data dir,
    audio seconds, spec entries, seconds taken)."""
    import concurrent.futures as cf

    from voxsrc2020_speaker_verification_tpu_torch.data import audio
    from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "wav"))
    rng = np.random.RandomState(seed)
    banks = [speaker_bank(rng) for _ in range(RAW_BANKS)]
    t = np.arange(int(0.4 * 16000))
    rir = rng.randn(t.size) * np.exp(-t / (0.05 * 16000))
    rir[int(0.002 * 16000)] = 8.0  # direct path 2 ms in
    rir_path, noise_path = os.path.join(root, "rir.wav"), os.path.join(root, "noise.wav")
    audio.write_wav(rir_path, (rir * 3000).astype(np.float32))
    audio.write_wav(noise_path, (rng.randn(5 * 16000) * 1500).astype(np.float32))
    speakers = [f"id{i:05d}" for i in range(5994)]
    jobs = [(f"{speakers[rng.randint(len(speakers))]}-{i:05d}", rng.randint(RAW_BANKS),
             rng.uniform(*RAW_SECONDS), rng.randint(2 ** 31)) for i in range(RAW_UTTS)]

    def write(job):
        utt, bank, sec, useed = job
        r = np.random.RandomState(useed)
        n = int(sec * 10)
        units = banks[bank][r.randint(len(banks[bank]), size=n)] * r.uniform(0.3, 1.0, (n, 1))
        path = os.path.join(root, "wav", f"{utt}.wav")
        audio.write_wav(path, units.reshape(-1).astype(np.float32))
        return utt, path, n / 10.0

    with cf.ThreadPoolExecutor(8) as pool:
        written = list(pool.map(write, jobs))
    wav, utt2spk, specs = {}, {}, 0
    for i, (utt, path, _) in enumerate(written):
        wav[utt] = path
        if i % RAW_SPEC_EVERY == 0:
            wav[utt] = json.dumps({"source": path, "rir": rir_path, "noises": [
                {"path": noise_path, "snr": float(rng.uniform(5, 15)), "start": 0,
                 "extend": True}]}, separators=(",", ":"))
            specs += 1
        utt2spk[utt] = utt.split("-")[0]
    datadir.write_two_column(os.path.join(root, "wav.scp"), wav)
    datadir.save_utt2id(os.path.join(root, "utt2id.pkl"), datadir.build_utt2id(utt2spk, speakers))
    return root, sum(sec for *_, sec in written), specs, time.perf_counter() - t0


def raw_front_end_parts(dev, config, fields, noise):
    """Device ms of each part of one microbatch's front end at the step's
    shapes, each alone by torch.profiler: the dither draw, the int16 cast,
    K1 (dithered), K7, the crop gather, and the whole front end with its
    draw."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn, pipeline
    from voxsrc2020_speaker_verification_tpu_torch.ops.fbank import FbankConfig, draw_noise, fbank

    cfg = FbankConfig(num_bins=config.feat_dim, dither=config.dither)
    waves, ns, off, shift = fields
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draw = lambda: draw_noise(*waves.shape, cfg, gen, dev)
    x = waves.float()
    feats = fbank(x, cfg, noise)
    valid = pipeline.num_frames_batch(ns, cfg)
    normed = cmvn.sliding_cmvn(feats, valid)

    def front_end():
        return pipeline.waveform_to_features(waves, ns, off, shift, cfg, config.feat_length,
                                             window=config.cmn_window, noise=draw())

    return {"noise_draw": device_ms(draw),
            "cast": device_ms(lambda: waves.float()),
            "fbank_dither": device_ms(lambda: fbank(x, cfg, noise), "fbank_kernel"),
            "sliding_cmvn": device_ms(lambda: cmvn.sliding_cmvn(feats, valid),
                                      "sliding_cmvn_kernel"),
            "gather": device_ms(lambda: pipeline.crop_gather(normed, valid, off, shift,
                                                             config.feat_length)),
            "front_end": device_ms(front_end)}


def fbank_float64(waves, cfg, noise=None):
    """K1's function in float64 on the card: fbank_reference's framing and
    analysis matrices, every product and sum in float64."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    a, b, m = (torch.from_numpy(x).to(waves.device).double() for x in fb.analysis_matrices(cfg))
    frames = waves.double().unfold(1, cfg.frame_length, cfg.frame_shift)
    frames = frames[:, :fb.num_frames(waves.shape[1], cfg)]
    if noise is not None:
        frames = frames + cfg.dither * noise.double()
    re, im = frames @ a, frames @ b
    return torch.log(torch.clamp((re * re + im * im) @ m, min=fb.FLT_EPSILON))


def front_end_float64(fields, cfg, feat_length, window, noise):
    """ops/pipeline.py's front end in float64: fbank_float64, the float64
    plain sliding CMN, the same gather."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn, pipeline

    waves, ns, off, shift = fields
    valid = pipeline.num_frames_batch(ns, cfg)
    feats = cmvn.sliding_cmvn_reference(fbank_float64(waves.float(), cfg, noise), valid,
                                        window=window)
    return pipeline.crop_gather(feats, valid, off, shift, feat_length)


def hold_fp32(what, data, got, plain, exact):
    """A float32 result of the card against its plain version and a float64
    run (see TOL_FBANK): white-noise crops within TOL_FBANK of the plain
    version, the raw crops within twice the plain version's distance to
    float64 (at least TOL_FBANK). Returns the three distances."""
    e = {"vs_plain": abs_err(got, plain), "vs_float64": abs_err(got, exact),
         "plain_vs_float64": abs_err(plain, exact)}
    ok = (e["vs_plain"] <= TOL_FBANK if data == "white"
          else e["vs_float64"] <= 2 * max(TOL_FBANK, e["plain_vs_float64"]))
    if got.shape != plain.shape or not torch.isfinite(got).all() or not ok:
        fail(f"{what} on {data} crops: shape {tuple(got.shape)} vs {tuple(plain.shape)}, "
             f"errors {e} (TOL_FBANK {TOL_FBANK})")
    return e


def check_fbank_dither(dev, cfg, crops, noise):
    """K1's dithered variant at the raw step's microbatch shape, on
    ``crops`` {"white": waves, "crops": waves} with the same draws: held by
    hold_fp32, rerun bit for bit, and bit-equal to the dither-off kernel on
    the dithered wave for framed per-sample draws; times and bound on the
    raw crops."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    errors = {}
    for data, waves in crops.items():
        got = fb.fbank(waves, cfg, noise)
        errors[data] = hold_fp32("fbank dither", data, got, fb.fbank_reference(waves, cfg, noise),
                                 fbank_float64(waves, cfg, noise))
        if not torch.equal(got, fb.fbank(waves, cfg, noise)):
            fail(f"fbank dither: reruns on {data} crops differ")
    # the draws reach the right (frame, sample): with one draw a sample,
    # framed, the dithered variant is bit-equal to the dither-off one on
    # the dithered wave, whatever the conditioning of the bands
    waves = crops["crops"]
    u = torch.randn(waves.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 57),
                    device=dev)
    framed = u.unfold(1, cfg.frame_length, cfg.frame_shift)[:, :noise.shape[1]].contiguous()
    off = fb.FbankConfig(num_bins=cfg.num_bins, dither=0.0)
    framed_equal = torch.equal(fb.fbank(waves, dataclasses.replace(cfg, dither=1.0), framed),
                               fb.fbank(waves + u, off))
    if not framed_equal:
        fail("fbank dither: framed per-sample draws differ from the dither-off kernel on the "
             "dithered wave")
    b, t, length = noise.shape
    a, _, _ = fb.analysis_matrices(cfg)
    nfft, bins = a.shape[1], cfg.num_bins
    # per frame: the two analysis products, the dither's multiply-add on
    # each sample, the mel product
    flops = b * t * (2 * 2 * length * nfft + 2 * length + 2 * nfft * bins)
    nbytes = 4 * (waves.numel() + noise.numel() + 2 * a.size + nfft * bins + b * t * bins)
    bms, by = bound_ms(nbytes, flops, torch.float32)
    dev_ms = device_ms(lambda: fb.fbank(waves, cfg, noise), "fbank_kernel")
    dev_ms_off = device_ms(lambda: fb.fbank(waves, off), "fbank_kernel")
    emit({"phase": "kernel", "name": "fbank:dither", "device_ms": dev_ms,
          "device_ms_dither_off": dev_ms_off, "dither_over_dither_off": dev_ms / dev_ms_off})
    return dict(name="fbank:dither", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/fbank.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/fbank.py:210 (fbank with "
                         "dither_key: frames + dither * normal(key, (B, T, frame_length)))",
                max_abs_err=max(e["vs_plain"] for e in errors.values()), errors=errors,
                tolerance=TOL_FBANK, tolerance_rule="white-noise crops: |kernel - plain| <= "
                "TOL_FBANK; raw crops: |kernel - float64| <= 2 max(TOL_FBANK, |plain - float64|)",
                dtype="float32", per=f"one raw-training microbatch ({b}, {waves.shape[1]}) "
                                     f"samples, {t} frames, dither {cfg.dither}",
                ms=time_ms(lambda: fb.fbank(waves, cfg, noise)),
                device_ms=dev_ms,
                plain_ms=time_ms(lambda: fb.fbank_reference(waves, cfg, noise)),
                plain_device_ms=device_ms(lambda: fb.fbank_reference(waves, cfg, noise)),
                device_ms_dither_off=dev_ms_off, dither_over_dither_off=dev_ms / dev_ms_off,
                framed_draws_bit_equal_to_dithered_wave=framed_equal, reruns_bit_equal=True, bound_ms=bms, bound_by=by, library_ms=None,
                library_note="none: no single PyTorch call computes Kaldi FBANK")


def raw_phase(dev, per_microbatch, smi, workdir):
    """Raw-audio training through ``cli.train.main --raw`` (see the module
    docstring). Returns (the K1 dithered row of the kernels line, the
    phase's launch counts, K7's device ms at the step's shape)."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
    from voxsrc2020_speaker_verification_tpu_torch.data.native import NativeRawBatchFeeder
    from voxsrc2020_speaker_verification_tpu_torch.losses import schedules
    from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn, pipeline
    from voxsrc2020_speaker_verification_tpu_torch.ops.fbank import (
        FbankConfig, draw_noise, num_frames, pcm16)
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        dither_generator, make_train_step, schedule_values)
    from voxsrc2020_speaker_verification_tpu_torch.utils.datadir import load_utt2id

    config, _ = get_recipe("res2net_vox2_dev_aug", model=TRAIN_MODEL, batch_size=TRAIN_BATCH,
                           num_accumulation_steps=TRAIN_ACCUM, feat_length=TRAIN_FRAMES,
                           seed=SEED, raw_audio=True)
    if ((config.bn_groups, config.bf16, config.num_classes, config.dither, config.cmn_context,
         config.cmn_window) != (TRAIN_GROUPS, True, 5994, 1.0, 150, 300)):
        fail(f"raw config is not the bench shape: {config}")
    root = os.path.join(workdir, "raw")
    data_dir, audio_s, specs, write_s = write_raw_data(os.path.join(root, config.dataset),
                                                       SEED + 51)
    cfg = FbankConfig(num_bins=config.feat_dim)

    # the feeder alone: batches a second with no step behind it; then the
    # first batch of one worker thread, a function of the seed, for the
    # checks and the resident step (RAW_WORKERS threads interleave utterances
    # in no fixed order)
    def raw_feeder(threads):
        return NativeRawBatchFeeder(os.path.join(data_dir, "wav.scp"),
                                    load_utt2id(os.path.join(data_dir, "utt2id.pkl")),
                                    config.feat_length, config.batch_size,
                                    config.num_accumulation_steps, cfg=cfg,
                                    context=config.cmn_context, num_threads=threads,
                                    seed=SEED + 1)

    feeder = raw_feeder(RAW_WORKERS)
    try:
        feeder.get()  # the queue fills while the workers start
        t0 = time.perf_counter()
        for _ in range(RAW_FEEDER_BATCHES):
            feeder.get()
        feeder_s = time.perf_counter() - t0
        feeder_errors, feeder_dead = feeder.decode_errors(), feeder.dead_shards()
    finally:
        feeder.close()
    if feeder_errors or feeder_dead:
        fail(f"raw: the feeder alone had {feeder_errors} decode errors, {feeder_dead} dead")
    feeder = raw_feeder(1)
    try:
        (waves, ns, off, shift), labels = feeder.get()
    finally:
        feeder.close()
    smax = pipeline.max_crop_samples(config.feat_length, config.cmn_context, cfg)
    if waves.shape != (config.num_accumulation_steps, config.batch_size, smax):
        fail(f"raw: feeder waves {waves.shape}, expected (A, B, {smax})")
    short = int(sum(num_frames(int(n), cfg) < config.feat_length for n in ns.reshape(-1)))

    argv = ["--recipe", "res2net_vox2_dev_aug", "--model", TRAIN_MODEL, "--raw",
            "--data-root", root, "--batch-size", str(TRAIN_BATCH),
            "--num-accumulation-steps", str(TRAIN_ACCUM), "--feat-length", str(TRAIN_FRAMES),
            "--num-workers", str(RAW_WORKERS), "--max-steps", str(RAW_STEPS),
            "--log-every", "1", "--no-checkpoint", "--seed", str(SEED)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run, text = quiet(train_cli.main, argv)
    torch.cuda.synchronize()
    counts = kernels.function_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = run.result.history
    if run.feeder != "native" or run.decode_errors != 0 or not text.startswith("feeder: native"):
        fail(f"raw: feeder {run.feeder}, {run.decode_errors} decode errors: {text[:200]!r}")
    if [h["step"] for h in hist] != list(range(1, RAW_STEPS + 1)):
        fail(f"raw: steps {[h['step'] for h in hist]}")
    for h in hist:
        lr, margin = schedule_values(config, h["step"] - 1)
        total = float(schedules.total_margin(config.projection, margin))
        if not math.isfinite(h["loss"]):
            fail(f"raw: non-finite loss at step {h['step']}")
        if h["learning_rate"] != lr or h["margin"] != total:
            fail(f"raw: step {h['step']} lr {h['learning_rate']} margin {h['margin']}, "
                 f"schedules say {lr}, {total}")
    microbatches = RAW_STEPS * config.num_accumulation_steps
    expected = {**{k: microbatches * n for k, n in per_microbatch.items()},
                "fbank.fbank_f32:dither": microbatches, "fbank.fbank_f32:plain": 0,
                "sliding_cmvn.sliding_cmvn": microbatches}
    for fn, n in expected.items():
        if counts[fn] != n:
            fail(f"raw: {fn} launched {counts[fn]} times, expected {n}")
    for fn in EVAL_KERNEL_FNS:
        if counts[fn]:
            fail(f"raw: eval kernel {fn} launched {counts[fn]} times")
    step_s = [b["time"] - a["time"] for a, b in zip(hist, hist[1:])]
    med = statistics.median(step_s)
    trained_audio = config.effective_batch * config.feat_length / 100.0
    state = run.result.state
    del run

    # one microbatch's front end on the card against its plain version and
    # float64, on one fixed draw, and on white-noise crops of its lengths
    # (hold_fp32); reruns bit for bit
    fields = [torch.from_numpy(x[0]).to(dev) for x in (waves, ns, off, shift)]
    dcfg = FbankConfig(num_bins=config.feat_dim, dither=config.dither)
    noise = draw_noise(config.batch_size, smax, dcfg, dither_generator(config, 0, 0, dev), dev)
    kw = dict(window=config.cmn_window, context=config.cmn_context, noise=noise)
    white = torch.from_numpy(pcm16(np.random.RandomState(SEED + 55).randn(*fields[0].shape)
                                   * 3000).astype(np.float32)).to(dev)
    white *= torch.arange(smax, device=dev)[None, :] < fields[1][:, None]
    crops = {"white": white, "crops": fields[0].float()}
    pipe = {}
    for data, w in crops.items():
        f = [w, *fields[1:]]
        got = pipeline.waveform_to_features(*f, dcfg, config.feat_length, **kw)
        want = pipeline.waveform_to_features_reference(*f, dcfg, config.feat_length, **kw)
        pipe[data] = hold_fp32("raw pipeline", data, got, want, front_end_float64(
            f, dcfg, config.feat_length, config.cmn_window, noise))
        if not torch.equal((got == 0).all(-1), (want == 0).all(-1)):
            fail(f"raw pipeline on {data} crops: zero rows differ from the plain version's")
        if not torch.equal(got, pipeline.waveform_to_features(*f, dcfg, config.feat_length, **kw)):
            fail(f"raw pipeline on {data} crops: a rerun differs")
    if got.shape != (config.batch_size, config.feat_length, config.feat_dim):
        fail(f"raw pipeline: features {tuple(got.shape)}")
    k1 = check_fbank_dither(dev, dcfg, crops, noise)
    parts = raw_front_end_parts(dev, config, fields, noise)
    valid = pipeline.num_frames_batch(fields[1], cfg)
    k7_feats = torch.from_numpy(np.random.RandomState(SEED + 53).randn(
        config.batch_size, num_frames(smax, cfg), config.feat_dim).astype(np.float32) * 3
                                + 12).to(dev)
    k7_plan = cmvn.sliding_cmvn_plan(config.batch_size, k7_feats.shape[1], config.feat_dim, 300,
                                     True, False, 100, kernels.num_sms(dev))

    # the step alone from a resident batch: its time, then under the profiler
    step = make_train_step(config)
    resident = (tuple(torch.from_numpy(x).to(dev) for x in (waves, ns, off, shift)),
                torch.from_numpy(labels).long().to(dev))
    step(state, *resident)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, *resident)
    torch.cuda.synchronize()
    resident_ms = 1e3 * (time.perf_counter() - t0)
    profiled = step_device_time(step, state, resident, resident_ms,
                                names=("fbank_kernel", "sliding_cmvn_kernel"))
    emit({"phase": "raw", "model": TRAIN_MODEL, "recipe": "res2net_vox2_dev_aug",
          "dtype": "bfloat16", "batch": TRAIN_BATCH, "accumulation": TRAIN_ACCUM,
          "frames": TRAIN_FRAMES, "context": config.cmn_context, "dither": config.dither,
          "bn_groups": config.bn_groups, "crop_samples": smax, "feeder": "native",
          "data": {"utterances": RAW_UTTS, "seconds": list(RAW_SECONDS), "audio_s": audio_s,
                   "spec_entries": specs, "write_s": write_s},
          "feeder_alone": {"workers": RAW_WORKERS, "batches": RAW_FEEDER_BATCHES,
                           "seconds": feeder_s,
                           "batches_per_s": RAW_FEEDER_BATCHES / feeder_s,
                           "trained_audio_s_per_s": RAW_FEEDER_BATCHES * trained_audio / feeder_s,
                           "short_utterances_in_checked_batch": short},
          "steps": RAW_STEPS, "timed_steps": len(step_s), "step_ms": [1e3 * x for x in step_s],
          "step_ms_median": 1e3 * med, "audio_s_per_s": trained_audio / med,
          "peak_memory_bytes": peak, "losses": [h["loss"] for h in hist],
          "learning_rates": [h["learning_rate"] for h in hist],
          "margins": [h["margin"] for h in hist], "launches": counts,
          "launches_expected": expected, "pipeline_errors": pipe,
          "pipeline_rerun_bit_equal": True, "tolerance": TOL_FBANK,
          "tolerance_rule": k1["tolerance_rule"],
          "front_end_device_ms": parts, "resident_step_ms": resident_ms, **profiled, "card": smi})
    k7 = {"device_ms": device_ms(lambda: cmvn.sliding_cmvn(k7_feats, valid),
                                 "sliding_cmvn_kernel"),
          "plain_device_ms": device_ms(lambda: cmvn.sliding_cmvn_reference(k7_feats, valid)),
          "plan": {k: k7_plan[k] for k in ("tt", "fb", "grid", "smem")},
          "frames": k7_feats.shape[1], "per": "the raw step's microbatch, its num_valid"}
    k7["bound_ms"], k7["bound_by"] = bound_ms(2 * 4 * k7_feats.numel() + 4 * len(valid),
                                              8.0 * k7_feats.numel(), torch.float64)
    k1["launches"] = counts["fbank.fbank_f32:dither"]
    k1["launches_on"] = "raw phase, cli.train --raw, A per step"
    return k1, counts, k7


def export_phase(dev, state, config, workdir):
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import (
        export_inference_artifact, load_inference_artifact)

    artifact = export_inference_artifact(config, state, os.path.join(workdir, "trained"))
    rng = np.random.RandomState(SEED + 11)
    feats = rng.randn(8, 300, FEAT_DIM).astype(np.float32)
    mask = np.ones((8, 300), np.float32)
    mask[4:, 200:] = 0.0
    feats *= mask[..., None]
    _, embed = load_inference_artifact(artifact, dev)
    kernels.reset_launch_counts()
    got = embed(feats, mask).cpu().numpy()
    counts = kernels.launch_counts()
    _, cpu_embed = load_inference_artifact(artifact, "cpu")
    want = cpu_embed(feats, mask).numpy()
    cos_min = min(cos(got[i], want[i]) for i in range(len(got)))
    emit({"phase": "export", "artifact_step": state.step, "embeddings": list(got.shape),
          "launches": counts, "min_cos_gpu_vs_cpu": cos_min})
    if got.shape != (8, config_output_dim(config)) or not np.isfinite(got).all():
        fail(f"export: embeddings {got.shape} or non-finite")
    if not all(counts[k] > 0 for k in ("split_conv", "bn_act", "stats_pool", "split_stride2")):
        fail(f"export: the eval path did not run K2-K4 and K10: {counts}")
    if cos_min < TOL_CPU_COS:
        fail(f"export: GPU vs CPU embeddings, min cosine {cos_min}")


def config_output_dim(config):
    from voxsrc2020_speaker_verification_tpu_torch.models import get_model

    with torch.device("meta"):
        return get_model(config.model, feat_dim=config.feat_dim).config.output_dim


def speaker_bank(rng, units: int = 64) -> np.ndarray:
    """One synthetic speaker: ``units`` 100 ms sounds (16 kHz, int16 scale),
    each a mix of noise through the speaker's own 24-tap filter and a voiced
    harmonic stack at the speaker's f0."""
    taps = rng.randn(24) * np.exp(-np.arange(24) / 6.0)
    noise = rng.randn(units, 1600 + 23)
    breath = np.stack([np.convolve(n, taps, "valid") for n in noise])
    t = np.arange(1600) / 16000.0
    f0 = rng.uniform(90.0, 250.0)
    voiced = sum(np.sin(2 * np.pi * f0 * k * t + rng.rand()) / k for k in range(1, 6))
    mix = rng.uniform(0.0, 1.0, (units, 1))
    return (2000.0 * (breath / breath.std() * (1 - mix) + voiced * mix)).astype(np.float32)


def write_eval_data(root, seed):
    """The evaluate phase's data (see EVAL_*): a test dir of wavs (wav.scp,
    utt2spk, spk2utt) with its trial list, and a cohort dir of CM-compressed
    features (feats.scp, spk2utt). Returns (test dir, trials, cohort dir,
    audio seconds, seconds taken)."""
    import concurrent.futures as cf

    from voxsrc2020_speaker_verification_tpu_torch.data import audio, kaldi_io
    from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    test = os.path.join(root, "voxceleb1_o_cut")
    os.makedirs(os.path.join(test, "wav"))
    jobs, banks = [], []
    for s in range(EVAL_SPEAKERS):
        banks.append(speaker_bank(rng))
        for i in range(EVAL_UTTS + (1 if s < EVAL_LONG else 0)):
            sec = rng.uniform(*(EVAL_LONG_SECONDS if i == EVAL_UTTS else EVAL_SECONDS))
            jobs.append((f"id1{s:04d}-{i:05d}", s, sec, rng.randint(2 ** 31)))

    def write(job):
        utt, s, sec, useed = job
        r = np.random.RandomState(useed)
        n = int(sec * 10)
        units = banks[s][r.randint(len(banks[s]), size=n)] * r.uniform(0.3, 1.0, (n, 1))
        path = os.path.join(test, "wav", f"{utt}.wav")
        audio.write_wav(path, units.reshape(-1).astype(np.float32))
        return utt, path, n / 10.0

    with cf.ThreadPoolExecutor(8) as pool:
        written = list(pool.map(write, jobs))
    wav = {utt: path for utt, path, _ in written}
    utt2spk = {utt: utt.split("-")[0] for utt in wav}
    datadir.write_two_column(os.path.join(test, "wav.scp"), wav)
    datadir.write_two_column(os.path.join(test, "utt2spk"), utt2spk)
    by_spk = {}
    for utt in sorted(wav):
        by_spk.setdefault(utt2spk[utt], []).append(utt)
    datadir.write_spk2utt(os.path.join(test, "spk2utt"), by_spk)
    # the trial count of VoxCeleb1-O, half targets (ordered pairs of two
    # utterances of one speaker), half non-targets
    spks, utts = sorted(by_spk), sorted(wav)
    trials = os.path.join(root, "list_test_O.txt")
    with open(trials, "w") as f:
        for k in range(EVAL_TRIALS):
            if k % 2 == 0:
                a, b = rng.choice(by_spk[spks[rng.randint(len(spks))]], 2, replace=False)
            else:
                a, b = utts[rng.randint(len(utts))], utts[rng.randint(len(utts))]
                while utt2spk[a] == utt2spk[b]:
                    b = utts[rng.randint(len(utts))]
            f.write(f"{int(k % 2 == 0)} {a} {b}\n")
    # the cohort: log-mel-like features, a spectral envelope per speaker
    cohort = os.path.join(root, "voxceleb2_cohort")
    os.makedirs(cohort)
    spk2utt = {}
    with kaldi_io.ArkScpWriter(os.path.join(cohort, f"fbank{FEAT_DIM}.ark"),
                               os.path.join(cohort, f"fbank{FEAT_DIM}.scp"), compress=True) as w:
        for s in range(COHORT_SPEAKERS):
            env = rng.randn(1, FEAT_DIM) * 2 + 8
            for i in range(COHORT_UTTS):
                utt = f"id0{s:04d}-{i:03d}"
                t = int(rng.randint(*COHORT_FRAMES))
                w.write(utt, (env + rng.randn(t, FEAT_DIM)).astype(np.float32))
                spk2utt.setdefault(f"id0{s:04d}", []).append(utt)
    datadir.write_spk2utt(os.path.join(cohort, "spk2utt"), spk2utt)
    return test, trials, cohort, sum(sec for *_, sec in written), time.perf_counter() - t0


def subset_dir(src, dst, utts, extra_wav=None):
    """A data dir of ``utts`` of ``src``: wav.scp (with ``extra_wav``
    entries replacing or adding values), utt2spk and spk2utt."""
    from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

    os.makedirs(dst)
    wav = datadir.read_two_column(os.path.join(src, "wav.scp"))
    wav = {u: wav[u] for u in utts}
    wav.update(extra_wav or {})
    utt2spk = {u: u.split("-")[0] for u in wav}
    datadir.write_two_column(os.path.join(dst, "wav.scp"), wav)
    datadir.write_two_column(os.path.join(dst, "utt2spk"), utt2spk)
    spk2utt = {}
    for u in sorted(wav):
        spk2utt.setdefault(utt2spk[u], []).append(u)
    datadir.write_spk2utt(os.path.join(dst, "spk2utt"), spk2utt)
    return dst


def quiet(fn, *args):
    """(fn(*args), what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def timed_leg(fn, *args):
    """Run one leg with every launch count at 0: (result, printed text,
    seconds, per-kernel launches)."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, text = quiet(fn, *args)
    torch.cuda.synchronize()
    return out, text, time.perf_counter() - t0, kernels.launch_counts()


def min_cos(a, b, utts=None):
    utts = sorted(a) if utts is None else utts
    if sorted(utts) != sorted(set(utts) & set(b)):
        fail(f"evaluate: vectors missing: {sorted(set(utts) - set(b))[:5]}")
    return min(cos(a[u], b[u]) for u in utts)


def evaluate_phase(dev, exp_dir, workdir, smi, k7):
    """The evaluation leg through the port's CLIs (see the module docstring).
    ``k7`` is K7's row of the kernels line, repeated in the phase's last
    line. Returns the first device-CMVN leg's launch counts (K7's main
    path)."""
    import pickle

    from voxsrc2020_speaker_verification_tpu_torch import set_float32_precision
    from voxsrc2020_speaker_verification_tpu_torch.cli import evaluate as evaluate_cli
    from voxsrc2020_speaker_verification_tpu_torch.cli import export as export_cli
    from voxsrc2020_speaker_verification_tpu_torch.cli import extract as extract_cli
    from voxsrc2020_speaker_verification_tpu_torch.cli import score as score_cli
    from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
    from voxsrc2020_speaker_verification_tpu_torch.data.audio import write_wav
    from voxsrc2020_speaker_verification_tpu_torch.data.features import compute_features_for_dir
    from voxsrc2020_speaker_verification_tpu_torch.eval.metrics import evaluate_trials
    from voxsrc2020_speaker_verification_tpu_torch.eval.scoring import (
        _trial_index, cohort_stats, l2norm, read_trials)
    from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "eval")
    test, trials_path, cohort, audio_s, write_s = write_eval_data(root, SEED + 41)
    n_test = sum(1 for _ in open(os.path.join(test, "wav.scp")))
    emit({"phase": "evaluate_data", "test_utterances": n_test, "trials": EVAL_TRIALS,
          "cohort_utterances": COHORT_SPEAKERS * COHORT_UTTS, "audio_s": audio_s,
          "write_s": write_s, "cut": f"{n_test} of VoxCeleb1's {VOX1_O_UTTS} test utterances "
                                     f"({EVAL_SPEAKERS} speakers x {EVAL_UTTS} of 4-20 s + "
                                     f"{EVAL_LONG} of 60-145 s), synthetic audio", "card": smi})

    # featurize the test set on the card (K1), plain (uncompressed) store
    scp, _, feat_s, counts = timed_leg(
        lambda: compute_features_for_dir(test, FEAT_DIM, compress=False, device=dev))
    if counts["fbank"] == 0:
        fail(f"evaluate: featurization launched no K1: {counts}")
    frames = {u: int(n) for u, n in datadir.read_two_column(
        os.path.join(test, "utt2num_frames")).items()}
    store_audio_s = sum(frames.values()) / 100.0
    emit({"phase": "evaluate_featurize", "utterances": len(frames), "audio_s": store_audio_s,
          "seconds": feat_s, "audio_s_per_s": store_audio_s / feat_s, "launches": counts,
          "card": smi})

    # 1. export the LMFT run's final checkpoint
    artifact, text, export_s, _ = timed_leg(export_cli.main, ["--exp-dir", exp_dir])
    with open(os.path.join(artifact, "projection_weight.pkl"), "rb") as f:
        rows = pickle.load(f)
    if rows.shape != (2 * 5994, 192):
        fail(f"evaluate: projection rows {rows.shape}, expected (11988, 192)")

    # the test set with host and with device CMVN (K7), full size, in turns
    # (host, device, device, host): the first extraction of the phase also
    # pays the allocator's and the kernels' first calls at these shapes
    xv = os.path.join(root, "xv")
    legs = {"host": [], "device": []}
    for i, mode in enumerate(("host", "device", "device", "host")):
        scp_, _, sec, counts = timed_leg(extract_cli.main, [
            "--artifact", artifact, "--data-dir", test, "--out", f"{xv}_{mode}{i}",
            "--cmvn", mode])
        legs[mode].append(dict(vectors=dict(kaldi_io.read_vec_flt_scp(scp_)), seconds=sec,
                               counts=counts, audio_s_per_s=store_audio_s / sec))
        need = ("split_conv", "bn_act", "stats_pool", "split_stride2") + (
            ("sliding_cmvn",) if mode == "device" else ())
        if any(counts[k] == 0 for k in need) or (mode == "host" and counts["sliding_cmvn"]):
            fail(f"evaluate: extract --cmvn {mode} launches {counts}")
    host = legs["host"][0]["vectors"]
    bad = [u for u, v in host.items() if v.shape != (192,) or not np.isfinite(v).all()]
    if len(host) != n_test or bad:
        fail(f"evaluate: {len(host)} embeddings of {n_test}, bad shape or non-finite: {bad[:5]}")
    cos_cmvn = min(min_cos(host, leg["vectors"]) for leg in legs["device"])
    # K7's launches by shape, from the lengths written, must be the counted
    # ones; with K7's device time at each shape they give its sum over the leg
    mix = {f"{b}x{t}": c for (b, t), c in extract_cli.cmvn_launch_mix(frames.values()).items()}
    if sum(mix.values()) != legs["device"][0]["counts"]["sliding_cmvn"]:
        fail(f"evaluate: K7 launches by shape {mix} vs counted {legs['device'][0]['counts']}")
    timed = all(k in k7["by_shape"] for k in mix)
    k7_sum, k7_bound = ((sum(c * k7["by_shape"][k][m] for k, c in mix.items())
                         for m in ("device_ms", "bound_ms")) if timed else (None, None))
    extract_rate = {m: statistics.median(leg["audio_s_per_s"] for leg in runs_)
                    for m, runs_ in legs.items()}
    emit({"phase": "evaluate_extract", "utterances": n_test, "audio_s": store_audio_s,
          "order": "host, device, device, host",
          **{f"{m}_cmvn": [{k: v for k, v in leg.items() if k != "vectors"} for leg in runs_]
             for m, runs_ in legs.items()},
          "audio_s_per_s_median": extract_rate,
          "min_cos_device_vs_host_cmvn": cos_cmvn, "tolerance": TOL_EXTRACT_COS,
          "k7_launches_by_shape": mix, "k7_device_ms_sum": k7_sum, "k7_bound_ms_sum": k7_bound,
          "note": "each call loads the artifact and builds the model; k7_*_sum is the "
                  "launches at each shape times K7's device ms (bound) there (kernels line)",
          "card": smi})
    if cos_cmvn < TOL_EXTRACT_COS:
        fail(f"evaluate: --cmvn device vs host, min cosine {cos_cmvn}")

    # 2. evaluate twice into one --out-dir: the cohort set's speaker means,
    # then the projection rows (the test xvectors are reused)
    out_dir = os.path.join(root, "out")
    common = ["--test-dir", test, "--trials", f"O={trials_path}", "--out-dir", out_dir]
    res_dir, text_dir, eval_s, counts_eval = timed_leg(evaluate_cli.main, [
        "--exp-dir", exp_dir, "--cohort-dir", cohort] + common)
    res_w, text_w, eval_w_s, _ = timed_leg(evaluate_cli.main, [
        "--artifact", artifact, "--cohort-weights",
        os.path.join(artifact, "projection_weight.pkl")] + common)
    if "exporting" in text_dir or text_w.count("extracting") != 0:
        fail(f"evaluate: the artifact or the test xvectors were not reused:\n{text_dir}{text_w}")
    # the default --cmvn (device) runs K7
    if any(counts_eval[k] == 0 for k in ("split_conv", "bn_act", "stats_pool", "sliding_cmvn",
                                          "split_stride2")):
        fail(f"evaluate: cli.evaluate launches {counts_eval}")
    for res in (res_dir, res_w):
        if not all(math.isfinite(x) for pair in res["O"].values() for x in pair):
            fail(f"evaluate: non-finite EER/minDCF {res}")

    # cli.score: cosine alone and asnorm against the 11,988 rows, top-400;
    # the printed EER and minDCF equal eval/metrics of the --out file
    test_scp = os.path.join(out_dir, f"xvector_{os.path.basename(test)}.scp")
    score_s, printed = {}, {}
    for name, extra in (("cosine", []), ("asnorm", [
            "--cohort-weights", os.path.join(artifact, "projection_weight.pkl"),
            "--topk", str(EVAL_TOPK)])):
        out = os.path.join(root, f"scores_{name}.txt")
        (mode, eer, dcf), text, score_s[name], _ = timed_leg(score_cli.main, [
            "--trials", trials_path, "--xvectors", test_scp, "--out", out] + extra)
        got = np.loadtxt(out, dtype=str)
        trials = read_trials(trials_path)
        if len(got) != EVAL_TRIALS or [tuple(r[:2]) for r in got] != [t[1:] for t in trials]:
            fail(f"evaluate: {out} does not list the {EVAL_TRIALS} trials in order")
        eer2, dcf2 = evaluate_trials(trials, got[:, 2].astype(np.float64))
        want = f"{mode}: EER {eer2:.4f}%  minDCF(p=0.01) {dcf2:.4f}"
        if text.strip() != want:
            fail(f"evaluate: cli.score printed {text.strip()!r}, its scores give {want!r}")
        printed[name] = text.strip()

    # the asnorm cohort statistics on the card against float64 numpy
    xvec = {u: l2norm(v) for u, v in kaldi_io.read_vec_flt_scp(test_scp)}
    tmat, _, _ = _trial_index(xvec, read_trials(trials_path))
    mean, std = cohort_stats(tmat, rows, topk=EVAL_TOPK, device=dev)
    scores64 = tmat.astype(np.float64) @ rows.astype(np.float64).T
    top = -np.partition(-scores64, EVAL_TOPK - 1, axis=1)[:, :EVAL_TOPK]
    err_stats = max(float(np.abs(mean - top.mean(1)).max()), float(np.abs(std - top.std(1)).max()))
    if err_stats > TOL_COHORT_STATS:
        fail(f"evaluate: cohort top-{EVAL_TOPK} statistics on the card vs float64: {err_stats}")
    # eval/scoring.py:_device_topk_stats (the float32 trial x cohort product,
    # top-k, mean and std) at this run's trial-side vectors x the cohort
    # rows: its time, and its bound (inputs read once, the two statistics
    # written; 2 N C D float32 operations on the CUDA cores)
    n_t, d = tmat.shape
    topk_bound = bound_ms(4 * (n_t + len(rows)) * d + 2 * 8 * n_t, 2.0 * n_t * len(rows) * d,
                          torch.float32)
    topk_stats = {"trial_vectors": n_t, "cohort_rows": len(rows), "dim": d,
                  "ms": time_ms(lambda: cohort_stats(tmat, rows, topk=EVAL_TOPK, device=dev)),
                  "device_ms": device_ms(lambda: cohort_stats(tmat, rows, topk=EVAL_TOPK,
                                                              device=dev)),
                  "bound_ms": topk_bound[0], "bound_by": topk_bound[1]}
    emit({"phase": "evaluate_score", "trials": EVAL_TRIALS, "cohort_rows": len(rows),
          "topk": EVAL_TOPK, "score_s": score_s, "printed": printed,
          "evaluate_s": {"cohort_dir": eval_s, "cohort_weights": eval_w_s},
          "evaluate": {"cohort_dir": res_dir["O"], "cohort_weights": res_w["O"]},
          "evaluate_printed": [text_dir.strip().splitlines()[-1], text_w.strip().splitlines()[-1]],
          "max_abs_err_cohort_stats_vs_float64": err_stats, "tolerance": TOL_COHORT_STATS,
          "device_topk_stats": topk_stats,
          "note": "synthetic audio and a model trained for a few steps on random "
                  "features: the EER checks the plumbing only", "card": smi})

    # 3. a subset through cli.extract: its own plain store, then the bf16
    # wire and --raw straight from wav.scp, one entry a JSON augmentation spec
    utts = sorted(host)[:EVAL_SUBSET]
    spec_utt = utts[1]
    spec = {"source": os.path.join(test, "wav", f"{spec_utt}.wav"),
            "rir": os.path.join(root, "rir.wav"),
            "noises": [{"path": os.path.join(test, "wav", f"{utts[-1]}.wav"), "snr": 10,
                        "start": 0, "extend": True}]}
    rir_rng = np.random.RandomState(SEED + 43)
    rir = rir_rng.randn(4800) * np.exp(-np.arange(4800) / 640.0)
    rir[40] = 3.0
    write_wav(os.path.join(root, "rir.wav"), (rir * 8000).astype(np.float32))
    sub = subset_dir(test, os.path.join(root, "subset"), utts,
                     {spec_utt: json.dumps(spec, separators=(",", ":"))})
    compute_features_for_dir(sub, FEAT_DIM, compress=False, device=dev)
    sub_frames = sum(int(n) for n in datadir.read_two_column(
        os.path.join(sub, "utt2num_frames")).values())
    runs = {}
    for name, extra in (("store", []), ("bf16", ["--wire", "bfloat16"]), ("raw", ["--raw"])):
        scp_, text, sec, counts = timed_leg(extract_cli.main, [
            "--artifact", artifact, "--data-dir", sub, "--out", os.path.join(root, f"sub_{name}"),
            *extra])
        runs[name] = dict(vectors=dict(kaldi_io.read_vec_flt_scp(scp_)), seconds=sec,
                          counts=counts, printed=text.strip().splitlines()[0])
    if runs["raw"]["counts"]["fbank"] == 0:
        fail(f"evaluate: extract --raw launched no K1: {runs['raw']['counts']}")
    for name, r in runs.items():  # the default --cmvn (device) runs K7
        if r["counts"]["sliding_cmvn"] == 0:
            fail(f"evaluate: default extract ({name}) launched no K7: {r['counts']}")
    cos_bf16 = min_cos(runs["store"]["vectors"], runs["bf16"]["vectors"])
    cos_raw = min_cos(runs["store"]["vectors"], runs["raw"]["vectors"])
    cos_spec_changed = cos(runs["store"]["vectors"][spec_utt], host[spec_utt])

    # the CPU plain path (float32) on the 16 shortest utterances
    short = sorted(host, key=lambda u: frames[u])[:EVAL_CPU_UTTS]
    cpu_dir = subset_dir(test, os.path.join(root, "cpu"), short)
    with kaldi_io.ArkScpWriter(os.path.join(cpu_dir, "fbank80.ark"),
                               os.path.join(cpu_dir, "fbank80.scp")) as w:
        for u, m in kaldi_io.read_mat_scp(os.path.join(test, "fbank80.scp")):
            if u in short:
                w.write(u, m)
    fp32 = os.path.join(root, "artifact_fp32")
    shutil.copytree(artifact, fp32)
    with open(os.path.join(fp32, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(fp32, "config.json"), "w") as f:
        json.dump({**cfg, "bf16": False}, f)
    t0 = time.perf_counter()
    cpu_scp, _ = quiet(extract_cli.main, [
        "--artifact", fp32, "--data-dir", cpu_dir, "--out", os.path.join(root, "cpu_xv"),
        "--batch-size", str(EVAL_CPU_UTTS), "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    cpu_vec = dict(kaldi_io.read_vec_flt_scp(cpu_scp))
    cos_cpu = min_cos(cpu_vec, host, short)
    # the same float32 artifact extracted on the card: through cli.extract
    # (its precision rule: TF32 off) and through extract_dataset with cuDNN's
    # and cuBLAS's TF32 on (PyTorch's default, which the CLIs kept before the
    # rule), each against the CPU's float32 embeddings
    tf32 = {}
    for name, on in (("tf32_off", False), ("tf32_on", True)):
        out_dir = os.path.join(root, f"xv_{name}")
        if on:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                scp = quiet(functools.partial(extract_cli.extract_dataset, batch_size=EVAL_CPU_UTTS,
                                              device=dev), fp32, cpu_dir, out_dir)[0]
            finally:
                set_float32_precision()
        else:
            scp = quiet(extract_cli.main, ["--artifact", fp32, "--data-dir", cpu_dir, "--out",
                                           out_dir, "--batch-size", str(EVAL_CPU_UTTS)])[0]
        vec = dict(kaldi_io.read_vec_flt_scp(scp))
        tf32[name] = {"min_cos_vs_cpu_fp32": min_cos(vec, cpu_vec, short),
                      "max_abs_diff_vs_cpu_fp32": max(float(np.abs(vec[u] - cpu_vec[u]).max())
                                                      for u in short)}
    emit({"phase": "evaluate_tf32", "utterances": len(short), "artifact": "float32 (bf16 false)",
          **tf32, "card": smi})
    emit({"phase": "evaluate_subset", "utterances": len(utts), "audio_s": sub_frames / 100.0,
          "spec_utterance": spec_utt, "renderer": runs["raw"]["printed"],
          **{name: {k: v for k, v in r.items() if k not in ("vectors", "printed")}
             for name, r in runs.items()},
          "min_cos_bf16_vs_float32_wire": cos_bf16, "min_cos_raw_vs_store": cos_raw,
          "cos_spec_vs_plain_wav": cos_spec_changed, "cpu_utterances": len(short),
          "cpu_s": cpu_s, "min_cos_gpu_bf16_vs_cpu_fp32": cos_cpu,
          "tolerance": {"wire_raw": TOL_EXTRACT_COS, "cpu": TOL_CPU_COS}, "card": smi})
    if cos_bf16 < TOL_EXTRACT_COS or cos_raw < TOL_EXTRACT_COS or cos_cpu < TOL_CPU_COS:
        fail(f"evaluate: bf16 wire {cos_bf16}, raw {cos_raw}, GPU vs CPU {cos_cpu}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "evaluate", "seconds": seconds, "export_s": export_s,
          "featurize_audio_s_per_s": store_audio_s / feat_s,
          "extract_audio_s_per_s_median": extract_rate, "score_s": score_s,
          "k7": {k: k7[k] for k in ("ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
                                    "plain_device_ms", "per")},
          "k7_launches_by_shape": mix, "k7_device_ms_sum": k7_sum, "k7_bound_ms_sum": k7_bound,
          "card": smi})
    return legs["device"][0]["counts"]


# ----------------------------------------------------------------------
# phase 4: serving over TCP
# ----------------------------------------------------------------------

def cos(a, b) -> float:
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


# ----------------------------------------------------------------------
# phase 11: the remaining encoders
# ----------------------------------------------------------------------

def register_thin_variants():
    """Thin variants of the four families for the float32 card-vs-CPU step
    (the attention head on the thin Res2Net; DPN keeps its 10-channel stem)."""
    from voxsrc2020_speaker_verification_tpu_torch import models
    from voxsrc2020_speaker_verification_tpu_torch.models import dpn, ecapa

    models.register_res2net_variant(
        "res2net_att_thin_smoke", num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
        width=(4, 8), split=4, output_dim=16, pool="att_stats")
    dpn.DPN_CONFIGS["dpn_thin_smoke"] = dpn.DpnConfig(
        name="dpn_thin_smoke", output_dim=16, bw=8, k_r=8, cardinality=4, k_sec=(2, 1, 2, 1),
        inc_sec=(4, 4, 4, 8))
    models.register_tdnn_variant("tdnn_thin_smoke", block_filters=(16, 16, 16, 16, 32),
                                 output_dim=16)
    ecapa.ECAPA_CONFIGS["ecapa_thin_smoke"] = ecapa.EcapaConfig(
        name="ecapa_thin_smoke", channels=16, split=4, mfa_dim=24, att_dim=8, output_dim=16)
    return ("res2net_att_thin_smoke", "dpn_thin_smoke", "tdnn_thin_smoke", "ecapa_thin_smoke")


def k5_calls(config, remat_stages):
    """K5's, K9 / K9b's, K11 / K11b's and K4 / K4b's calls per microbatch of
    ``config``'s model, read off one training forward and backward of the
    full-width model through the plain path on the CPU (a small input:
    bn_groups rows of 24 frames): the ``ops.bn_train``, ``split_chain_train``,
    ``split_stride2_train`` and ``ops.stats_pool`` calls of the forward and of
    the rematerialized recompute in the backward, K5's each by the design ``bn_train_plan``
    gives it at the card's shape (B = config.batch_size, the recorded length
    scaled from 24 frames to config.feat_length, the recorded bins), K4's by
    ``stats_pool_plan``'s at the card's frames. Returns the expected
    per-microbatch launch counts and the forward's K5 calls by design
    (``bn_train.<function>:<path>`` of the forward keys)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import get_model
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    calls, chains, pools, stride2, phase = [], [], [], [], ["fwd"]
    orig, orig_chain, orig_pool = ops.bn_train, rn.split_chain_train, ops.stats_pool
    orig_s2 = rn.split_stride2_train

    def record(x, *args, **kw):
        mode = 0 if kw.get("shortcut") is None else (
            2 if kw.get("shortcut_running_mean") is not None else 1)
        calls.append((phase[0], tuple(x.shape), mode, bool(kw.get("relu", False))))
        return orig(x, *args, **kw)

    def record_pool(x, *args, **kw):
        pools.append((phase[0], tuple(x.shape)))
        return orig_pool(x, *args, **kw)

    def record_chain(x, weight, running_means, *args, **kw):
        chains.append((phase[0], len(running_means) + 1))
        return orig_chain(x, weight, running_means, *args, **kw)

    def record_stride2(*args, **kw):
        stride2.append(phase[0])
        return orig_s2(*args, **kw)

    torch.manual_seed(SEED)
    model = get_model(config.model, feat_dim=config.feat_dim, remat=bool(remat_stages),
                      remat_stages=remat_stages)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    model.set_bn_groups(config.bn_groups)
    ops.bn_train, rn.split_chain_train, ops.stats_pool = record, record_chain, record_pool
    rn.split_stride2_train = record_stride2
    try:
        y = model(torch.randn(config.bn_groups, 24, config.feat_dim), True)
        phase[0] = "recompute"
        y.square().sum().backward()
    finally:
        ops.bn_train, rn.split_chain_train, ops.stats_pool = orig, orig_chain, orig_pool
        rn.split_stride2_train = orig_s2

    def card_shape(shape):
        if len(shape) == 2:
            return (config.batch_size, shape[1])
        return (config.batch_size, shape[1], -(-shape[2] * config.feat_length // 24), shape[3])

    k5 = dict.fromkeys(K5_LAUNCH_KEYS, 0)
    by_design = {}
    for ph, shape, mode, relu in calls:
        fwd, bwd = k5_functions(card_shape(shape), config.bn_groups, mode, relu)
        k5[fwd] += 1
        if ph == "fwd":
            k5[bwd] += 1
            by_design[fwd] = by_design.get(fwd, 0) + 1
    k9 = {ph: {(None, None, s): sum(1 for p, s2 in chains if p == ph and s2 == s)
               for s in {s for _, s in chains}} for ph in ("fwd", "recompute")}
    if sum(1 for ph, _ in pools if ph == "fwd") != 1:
        fail(f"k5_calls {config.model}: stats_pool calls {pools}, not one a forward")
    pool = {}
    for ph, (_, c, t, w) in pools:
        frames = -(-t * config.feat_length // 24)
        d = ops.stats_pool_plan(config.batch_size, frames, w, c, torch.bfloat16)["design"]
        for fn in ("stats_pool.stats_pool", "stats_pool_bwd.stats_pool_bwd"):
            if fn.startswith("stats_pool.") or ph == "fwd":
                pool[f"{fn}:{d}"] = pool.get(f"{fn}:{d}", 0) + 1
    k11 = k11_launches({None: stride2.count("fwd")}, {None: stride2.count("recompute")})
    return {**k9_launches(k9["fwd"], k9["recompute"]), **k11, **pool, **k5}, by_design


def encoder_train(dev, spec, workdir, smi):
    """One family through ``cli.train.main --synthetic`` (ENCODER_RUNS)."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
    from voxsrc2020_speaker_verification_tpu_torch.losses import schedules
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import schedule_values

    model, recipe, batch, accum, stages, extra = spec
    exp_root = os.path.join(workdir, "exp_encoders")
    argv = ["--recipe", recipe, "--model", model, "--synthetic", "--batch-size", str(batch),
            "--num-accumulation-steps", str(accum), "--max-steps", str(ENCODER_STEPS),
            "--log-every", "1", "--no-checkpoint", "--exp-root", exp_root, "--seed", str(SEED),
            *extra] + (["--remat-stages", *map(str, stages)] if stages else [])
    recipe_cfg, _ = get_recipe(recipe, model=model)
    overrides = dict(batch_size=batch, num_accumulation_steps=accum, exp_root=exp_root, seed=SEED,
                     raw_audio=False, specaug="--specaug" in extra)
    if stages:
        overrides.update(remat=True, remat_stages=tuple(stages))
    config, _ = get_recipe(recipe, model=model, **overrides)
    if config.effective_batch != recipe_cfg.effective_batch:
        fail(f"encoders {model}: effective batch {config.effective_batch}, the recipe's "
             f"{recipe_cfg.effective_batch}")
    per_microbatch, k5_by_design = k5_calls(config, stages)
    att = "_att" in model or model.startswith("ecapa")
    per_microbatch.update({
        "att_pool.att_pool_fwd": int(att), "att_pool.att_pool_bwd": int(att),
        **{k: (v if config.projection == "sc_cm_linear" else 0)
           for k, v in K6_SLAB_PER_MICROBATCH.items()}})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.function_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = run.result.history
    if len(hist) != ENCODER_STEPS or run.feeder != "synthetic":
        fail(f"encoders {model}: {len(hist)} logged steps, feeder {run.feeder}")
    for h in hist:
        lr, margin = schedule_values(config, h["step"] - 1)
        total = float(schedules.total_margin(config.projection, margin))
        if not math.isfinite(h["loss"]):
            fail(f"encoders {model}: non-finite loss at step {h['step']}")
        if h["learning_rate"] != lr or h["margin"] != total:
            fail(f"encoders {model}: step {h['step']} lr {h['learning_rate']} margin "
                 f"{h['margin']}, schedules say {lr}, {total}")
    microbatches = ENCODER_STEPS * accum
    for fn, n in per_microbatch.items():
        if counts[fn] != microbatches * n:
            fail(f"encoders {model}: {fn} launched {counts[fn]} times, expected "
                 f"{microbatches} x {n}")
    for fn in EVAL_KERNEL_FNS:
        if counts[fn]:
            fail(f"encoders {model}: eval kernel {fn} launched {counts[fn]} times")
    step_s = [b["time"] - a["time"] for a, b in zip(hist, hist[1:])]
    med = statistics.median(step_s)
    emit({"phase": "encoders_train", "model": model, "recipe": recipe, "dtype": "bfloat16",
          "microbatch": batch, "accumulation": accum, "effective_batch": config.effective_batch,
          "recipe_microbatch": recipe_cfg.batch_size,
          "recipe_accumulation": recipe_cfg.num_accumulation_steps,
          "frames": config.feat_length, "feat_dim": config.feat_dim,
          "bn_groups": config.bn_groups, "projection": config.projection,
          "specaug": config.specaug, "remat_stages": list(stages) if stages else None,
          "steps": ENCODER_STEPS, "timed_steps": len(step_s),
          "step_ms": [1e3 * x for x in step_s], "step_ms_median": 1e3 * med,
          "audio_s_per_s": config.effective_batch * config.feat_length / 100.0 / med,
          "peak_memory_bytes": peak, "seconds": wall,
          "losses": [h["loss"] for h in hist],
          "learning_rates": [h["learning_rate"] for h in hist],
          "margins": [h["margin"] for h in hist],
          "launches_per_microbatch": per_microbatch,
          "k5_calls_by_design_per_microbatch": k5_by_design,
          "launches": {k: v for k, v in counts.items() if v}, "card": smi})
    state = run.result.state
    del run
    return state, config, counts


def encoder_extract(dev, state, config, workdir):
    """One family in eval mode through eval/extract.py's bucketed, masked
    path from its exported artifact (see ENCODER_EXTRACT_LENGTHS)."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import (
        export_inference_artifact, load_inference_artifact)
    from voxsrc2020_speaker_verification_tpu_torch.eval.extract import (
        default_batch_size, extract_embeddings, make_bucketed_embed_fn, to_numpy)
    from voxsrc2020_speaker_verification_tpu_torch.speaker_net import SpeakerNet

    artifact = export_inference_artifact(config, state, os.path.join(workdir, f"art_{config.model}"))
    cfg, embed = load_inference_artifact(artifact, dev)
    if cfg.model != config.model or not cfg.bf16:
        fail(f"encoders {config.model}: the artifact's config {cfg}")
    batch = default_batch_size(cfg.model)
    rng = np.random.RandomState(SEED + 41)
    lengths = rng.randint(ENCODER_EXTRACT_LENGTHS[0], ENCODER_EXTRACT_LENGTHS[1] + 1, batch)
    lengths[:len(ENCODER_EXACT_LENGTHS)] = ENCODER_EXACT_LENGTHS
    feats = [(f"utt{i:03d}", (rng.randn(1, cfg.feat_dim) * 2
                              + rng.randn(n, cfg.feat_dim)).astype(np.float32))
             for i, n in enumerate(lengths)]
    fn = make_bucketed_embed_fn(embed, batch)
    extract_embeddings(fn, feats, batch_size=batch)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = extract_embeddings(fn, feats, batch_size=batch)
    seconds = time.perf_counter() - t0
    counts = kernels.function_launch_counts()
    att = "_att" in cfg.model or cfg.model.startswith("ecapa")
    # K10 once a stride-2 stage of the one forward: three in a Res2Net
    k10 = 3 if cfg.model.startswith("res2net") else 0
    if counts["att_pool.att_pool_fwd"] != int(att) or fn_total(counts, "stats_pool.stats_pool") != 1 \
            or fn_total(counts, "bn_act.bn_act") == 0 or counts["att_pool.att_pool_bwd"] \
            or fn_total(counts, "split_stride2.split_stride2") != k10:
        fail(f"encoders {cfg.model}: extraction launches {counts}")
    emb = np.stack([out[u] for u, _ in feats])
    if emb.shape != (batch, config_output_dim(cfg)) or not np.isfinite(emb).all():
        fail(f"encoders {cfg.model}: embeddings {emb.shape} or non-finite")
    exact = {}
    for u, f in feats[:len(ENCODER_EXACT_LENGTHS)]:
        e = to_numpy(embed(f[None], np.ones((1, len(f)), np.float32)))[0]
        exact[u] = cos(out[u], e)
    cpu_net = SpeakerNet(cfg.model, cfg.feat_dim)
    cpu_net.load_state_dict(torch.load(os.path.join(artifact, "weights.pt"), weights_only=True))
    cpu = {}
    for i in range(2):
        f = (rng.randn(ENCODER_CPU_FRAMES, cfg.feat_dim) * 2).astype(np.float32)
        m = np.ones((1, len(f)), np.float32)
        with torch.inference_mode():
            want = cpu_net.embed(torch.from_numpy(f[None]), torch.from_numpy(m))[0].numpy()
        cpu[f"cpu{i}"] = cos(to_numpy(embed(f[None], m))[0], want)
    line = {"phase": "encoders_extract", "model": cfg.model, "dtype": "bfloat16",
            "batch": batch, "bucket": 1000, "lengths": [int(v) for v in lengths],
            "ms": 1e3 * seconds, "audio_s_per_s": float(lengths.sum()) / 100.0 / seconds,
            "launches": {k: v for k, v in counts.items() if v},
            "min_cos_padded_vs_exact": min(exact.values()),
            "min_cos_gpu_bf16_vs_cpu_fp32": min(cpu.values()), "artifact_step": state.step}
    emit(line)
    if line["min_cos_padded_vs_exact"] < TOL_SERVED_COS:
        fail(f"encoders {cfg.model}: padded vs exact-length cosines {exact}")
    if line["min_cos_gpu_bf16_vs_cpu_fp32"] < TOL_CPU_COS:
        fail(f"encoders {cfg.model}: card vs CPU cosines {cpu}")
    return counts


def encoders_phase(dev, workdir, smi):
    """Phase 11: each family trained (ENCODER_RUNS), then extracted from its
    artifact; a float32 step on the card against the CPU for a thin variant
    of each. Returns the training and extraction launch counts by model."""
    t0 = time.perf_counter()
    train_counts, extract_counts = {}, {}
    for spec in ENCODER_RUNS:
        state, config, counts = encoder_train(dev, spec, workdir, smi)
        train_counts[config.model] = counts
        extract_counts[config.model] = encoder_extract(dev, state, config, workdir)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    for thin in register_thin_variants():
        train_parity_phase(dev, thin, THIN_PARITY_BATCH)
    # the thin ECAPA at 16 rows, printed: its stray there is the margin
    # head's max over sub-centers choosing the other center, on the card,
    # at two (row, class) pairs whose centers lie within 1e-5 in float64
    train_parity_phase(dev, "ecapa_thin_smoke", THIN_PARITY_PRINTED_BATCH, hard=False)
    emit({"phase": "encoders", "seconds": time.perf_counter() - t0})
    return train_counts, extract_counts


def serve_phase(dev, workdir, per_forward, split_per_forward):
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
        fn_counts = kernels.function_launch_counts()
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
        missing = [k for k in ("fbank", *per_forward) if counts[k] == 0]
        if missing:
            fail(f"kernels never launched while serving: {missing}")
        # every flush is one full-batch forward: its launches must be the
        # per-forward calls the kernel phase timed (forward_shapes)
        for name, n in per_forward.items():
            if counts[name] != flushes * n:
                fail(f"{name}: {counts[name]} launches in {flushes} forwards, "
                     f"expected {n} per forward")
        # and K2's by variant: the warpgroup-MMA one per group at w = 96, 192
        for name, n in split_per_forward.items():
            if fn_counts[name] != flushes * n:
                fail(f"{name}: {fn_counts[name]} launches in {flushes} forwards, "
                     f"expected {n} per forward")

        audio_s = sum(len(f) for f in feats) / 100.0 + sum(len(w) for w in waves) / 16000.0
        lat = sorted(latency)
        emit({"phase": "serve", "model": MODEL, "dtype": "bfloat16", "batch": BATCH,
              "requests": len(jobs), "score_ops": len(scores), "warmup_s": warmup_s,
              "wall_s": wall, "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
              "p50_latency_s": lat[len(lat) // 2],
              "p95_latency_s": lat[min(len(lat) - 1, int(math.ceil(0.95 * len(lat))) - 1)],
              "flushes": flushes, "launches": counts,
              "split_conv_launches": {k: v for k, v in fn_counts.items()
                                      if k.startswith("split_conv.")},
              "min_cos_served_vs_offline": cos_offline, "min_cos_wave_vs_feats": cos_wave,
              "min_cos_gpu_bf16_vs_cpu_fp32": cos_cpu,
              "device": torch.cuda.get_device_name(0)})
        return counts, fn_counts
    finally:
        server.shutdown()
        svc.close()
        server.server_close()


# ----------------------------------------------------------------------
# K1's general path, K5's spanning mode, K6's class-sharded mode;
# --single-chip, cli.launch and observability.trace
# ----------------------------------------------------------------------

# K1's general path: (config, seconds of one wave): 32 kHz with 25 ms frames
# (513 FFT bins) and a 64 ms frame at 16 kHz; GENERAL_FBANK_BATCH 32 kHz waves
# of GENERAL_FBANK_SECONDS through ops.fbank.fbank for the launch count
GENERAL_FBANK = ((dict(sample_rate=32000), 8.0), (dict(frame_length_ms=64.0), 8.0))
GENERAL_FBANK_BATCH, GENERAL_FBANK_SECONDS = 8, 4.0
# K5's spanning mode: one activation of SPAN_SHAPE split over two ranks,
# BN groups SPAN_GROUPS (every group spans both halves)
SPAN_SHAPE, SPAN_GROUPS, SPAN_RANKS = (256, 96, 200, 80), 1, 2
# and a real spanning shape: (a rank's rows, BN groups, data ranks) of
# res2net50_w8_s6_c16's stage-1 output on 16 data ranks at bn_groups 8 (a
# 256-row batch, 16 rows a rank: each group spans two ranks)
SPAN_REAL = ((16, 64, 200, 80), 8, 16)
# K6's class-sharded mode: cos_all of MARGIN_SPLIT over two class ranges
MARGIN_SPLIT = (2, 256, 5994)
# --single-chip: the reference's best system through cli.train on one card
SINGLE_CHIP_MODEL, SINGLE_CHIP_STEPS = "res2net200_w24_s4_c32_att", 2
# cli.launch on the card: two processes (gloo: they share the card), full
# width, float32, B x A rows, one step; its exp dirs held to one process
LAUNCH_MODEL, LAUNCH_BATCH, LAUNCH_ACCUM, LAUNCH_GROUPS = "res2net50_w8_s6_c16", 32, 2, 1
LAUNCH_TIMEOUT_S = 300
TRACE_STEPS = 2


def general_fbank_bound(cfg, batch, samples):
    """(bound ms, bound_by) of FBANK on ``batch`` waves of ``samples``: fp32
    FMA of the analysis (re and im) and of the mel sums over the packed mel
    weights (``mel_columns``: the nonzeros of M), against the waves, A/B and
    the packed weights read once and the features written once."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    t, nfft = fb.num_frames(samples, cfg), cfg.padded_frame_length // 2
    nnz = fb.mel_columns(fb.analysis_matrices(cfg)[2])[2].size
    flops = batch * (4 * t * cfg.frame_length * nfft + 2 * t * nnz)
    nbytes = 4 * (batch * samples + 2 * cfg.frame_length * nfft + nnz + batch * t * cfg.num_bins)
    return bound_ms(nbytes, flops, torch.float32)


def check_fbank_general(dev):
    """K1's general path (fbank_general_f32) at GENERAL_FBANK: against the
    plain version (TOL_FBANK) and float64, reruns bit for bit, one CUDA
    kernel a call (the profiler), times and bound; the dithered variant at
    the first config; then its launches through ops.fbank.fbank on a batch
    of 32 kHz waves, counted from 0, that batch against the plain version
    and its device time beside its bound."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    rng = np.random.RandomState(SEED + 12)
    shapes = []
    for kw, seconds in GENERAL_FBANK:
        cfg = fb.FbankConfig(num_bins=FEAT_DIM, dither=0.0, **kw)
        if fb.kernel_route(cfg) != "general":
            fail(f"fbank general: {kw} routes to {fb.kernel_route(cfg)}")
        n = int(seconds * cfg.sample_rate)
        wave = torch.from_numpy(fb.pcm16(rng.randn(1, n) * 3000).astype(np.float32)).to(dev)
        got = fb.fbank(wave, cfg)
        e = hold_fp32(f"fbank general {kw}", "white", got, fb.fbank_reference(wave, cfg),
                      fbank_float64(wave, cfg))
        rerun = torch.equal(got, fb.fbank(wave, cfg))
        if not rerun:
            fail(f"fbank general {kw}: reruns differ")
        bms, by = general_fbank_bound(cfg, 1, n)
        launched = cuda_kernels(lambda: fb.fbank(wave, cfg))
        if sum(launched.values()) != 1:
            fail(f"fbank general {kw}: CUDA kernels a call {launched} (one)")
        shapes.append(dict(
            config=kw, seconds=seconds, frames=fb.num_frames(n, cfg),
            fft_bins=cfg.padded_frame_length // 2, errors=e, reruns_bit_equal=rerun,
            kernels_a_call=launched,
            ms=time_ms(lambda: fb.fbank(wave, cfg), reps=20),
            device_ms=device_ms(lambda: fb.fbank(wave, cfg), "fbank_general_kernel"),
            plain_ms=time_ms(lambda: fb.fbank_reference(wave, cfg), reps=20),
            plain_device_ms=device_ms(lambda: fb.fbank_reference(wave, cfg)),
            bound_ms=bms, bound_by=by))
    # the dithered variant, with the plain version fed the same draws
    kw, seconds = GENERAL_FBANK[0]
    cfg = fb.FbankConfig(num_bins=FEAT_DIM, dither=1.0, **kw)
    n = int(seconds * cfg.sample_rate)
    wave = torch.from_numpy(fb.pcm16(rng.randn(2, n) * 3000).astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.randn(2, fb.num_frames(n, cfg), cfg.frame_length)
                             .astype(np.float32)).to(dev)
    dither = hold_fp32("fbank general dithered", "white", fb.fbank(wave, cfg, noise),
                       fb.fbank_reference(wave, cfg, noise), fbank_float64(wave, cfg, noise))
    dither.update(device_ms=device_ms(lambda: fb.fbank(wave, cfg, noise), "fbank_general_kernel"),
                  bound_ms=general_fbank_bound(cfg, 2, n)[0], waves=2, seconds=seconds)
    # the launches: a batch of 32 kHz waves through the library entry
    cfg = fb.FbankConfig(num_bins=FEAT_DIM, dither=0.0, **GENERAL_FBANK[0][0])
    waves = torch.from_numpy(fb.pcm16(rng.randn(GENERAL_FBANK_BATCH, int(
        GENERAL_FBANK_SECONDS * cfg.sample_rate)) * 3000).astype(np.float32)).to(dev)
    kernels.reset_launch_counts()
    feats = fb.fbank(waves, cfg)
    torch.cuda.synchronize()
    counts = kernels.function_launch_counts()
    launches = counts["fbank.fbank_general_f32:plain"]
    if launches < 1 or counts["fbank.fbank_f32:plain"] or not torch.isfinite(feats).all():
        fail(f"fbank general: launches {counts}")
    batch_err = abs_err(feats, fb.fbank_reference(waves, cfg))
    if batch_err > TOL_FBANK:
        fail(f"fbank general batch of {GENERAL_FBANK_BATCH}: {batch_err}")
    batch = dict(waves=GENERAL_FBANK_BATCH, seconds=GENERAL_FBANK_SECONDS, vs_plain=batch_err,
                 device_ms=device_ms(lambda: fb.fbank(waves, cfg), "fbank_general_kernel"),
                 plain_device_ms=device_ms(lambda: fb.fbank_reference(waves, cfg)),
                 bound_ms=general_fbank_bound(cfg, GENERAL_FBANK_BATCH, waves.shape[1])[0])
    first = shapes[0]
    emit({"phase": "kernel", "name": "fbank_general", "shapes": shapes, "dithered": dither,
          "batch": batch})
    return dict(name="fbank_general", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/fbank.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/fbank.py:191 (fbank at the "
                         "shapes the fast design refuses; = ops/pallas/fbank.py:85 @912d3e9^)",
                launches=launches,
                launches_on=f"ops.fbank.fbank, {GENERAL_FBANK_BATCH} waves of "
                            f"{GENERAL_FBANK_SECONDS} s at 32 kHz (no CLI takes another rate)",
                max_abs_err=max(s["errors"]["vs_plain"] for s in shapes),
                tolerance=TOL_FBANK, dtype="float32",
                per=f"one {first['seconds']} s wave at {first['config']}",
                ms=first["ms"], device_ms=first["device_ms"], plain_ms=first["plain_ms"],
                plain_device_ms=first["plain_device_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=None,
                library_note="none: no single PyTorch call computes Kaldi FBANK",
                shapes=shapes, dithered=dither, batch=batch,
                kernels_a_call=sum(first["kernels_a_call"].values()))


def cuda_kernels(fn, calls: int = 10, tries: int = 3):
    """CUDA kernels one call of ``fn`` launches, from torch.profiler: {name:
    count a call} over ``calls`` calls after a warm-up, rounded (the
    profiler has been seen to drop one event of a window); a window in
    which the profiler saw no device activity at all (it has been seen to
    miss a process's first window) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: round(e.count / calls) for e in prof.key_averages()
                if e.device_type.name == "CUDA"}
        if seen:
            return seen
    return seen


def span_halves(x, dy, st, layouts, blocks, relu=True):
    """K5's spanning mode over the rank blocks of one batch in one process
    (the partial sums added in place of the all-reduce): (y, dx)."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    sums = sum(ops.bn_span_partials(x[i], lay) for i, lay in zip(blocks, layouts))
    outs = [ops.bn_span_apply(x[i], sums, s[0], s[1], lay, relu=relu)
            for i, lay, s in zip(blocks, layouts, st)]
    bsums = sum(ops.bn_span_bwd_partials(x[i], dy[i], stats, lay, relu=relu)
                for i, lay, (_, stats) in zip(blocks, layouts, outs))
    dx = [ops.bn_span_bwd_apply(x[i], dy[i], stats, bsums, lay, relu=relu)[0]
          for i, lay, (_, stats) in zip(blocks, layouts, outs)]
    return torch.cat([o[0] for o in outs]), torch.cat(dx)


# a relu decision on which K5's spanning mode and a version it is held
# against may differ: where the float64 pre-relu value lies within this of
# zero (the two sum the moments in other orders; float32 rounding moves a
# normalized value by ~1e-6 at these shapes)
RELU_TIE = 1e-4


def relu_ties_exceeded(x, groups, flips):
    """Flipped relu decisions (``flips``) whose float64 pre-relu value,
    normalized with the batch groups' float64 moments, lies farther than
    RELU_TIE from zero (no shortcut: the value is x-hat)."""
    b, c = x.shape[:2]
    idx = flips.nonzero(as_tuple=True)
    if not idx[0].numel():
        return 0
    xg = x.movedim(1, -1).reshape(groups, -1, c)
    mean = torch.stack([g.double().mean(0) for g in xg])
    var = torch.stack([torch.square(g.double()).mean(0) for g in xg]) - torch.square(mean)
    grp, ch = idx[0] // (b // groups), idx[1]
    z = (x[idx].double() - mean[grp, ch]) * torch.rsqrt(var[grp, ch] + 1e-5)
    return int((z.abs() > RELU_TIE).sum())


def span_errors(xs, dys, rm, rv, layouts, blocks, groups):
    """K5's spanning mode over the rank blocks of ``xs`` (relu) against
    whole-batch K5 (its cluster design) and against the plain version on the
    same inputs (``bn_train_reference`` over the whole batch: what
    ``bn_span_reference`` computes when its all-reduce sums every rank's
    partials), forward, running update and backward; a rerun bit for bit.
    Relu flips are counted and those outside RELU_TIE of zero reported."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    stats = [[rm.clone(), rv.clone()] for _ in layouts]
    y, dx = span_halves(xs, dys, stats, layouts, blocks)
    y2, dx2 = span_halves(xs, dys, [[rm.clone(), rv.clone()] for _ in layouts], layouts, blocks)
    out = dict(reruns_bit_equal=bool(torch.equal(y, y2) and torch.equal(dx, dx2)))
    del y2, dx2
    for name, fn in (("vs_whole_k5", ops.bn_train), ("vs_plain", ops.bn_train_reference)):
        xi = xs.detach().requires_grad_(True)
        want = [rm.clone(), rv.clone()]
        yw = fn(xi, want[0], want[1], groups=groups, relu=True)
        yw.backward(dys)
        yw = yw.detach()
        same = (y > 0) == (yw > 0)
        out[name] = dict(
            y=rel_err(y, yw), dx=rel_err(dx * same, xi.grad * same),
            relu_flips=int((~same).sum()), flips_off_ties=relu_ties_exceeded(xs, groups, ~same),
            running=max(rel_err(a, b_) for st in stats for a, b_ in zip(st, want)))
        del xi, yw, same
    return out


def span_failures(errs):
    """The tolerance breaches of span_errors' output for each dtype."""
    bad = []
    for dtype, e in errs.items():
        if not e["reruns_bit_equal"]:
            bad.append(f"{dtype}: reruns differ")
        for vs in ("vs_whole_k5", "vs_plain"):
            v = e[vs]
            tol_y, tol_dx = ((TOL_FP32, TOL_K5_GRAD_FP32) if dtype == "float32"
                             else (TOL_TRAIN_BF16, TOL_TRAIN_BF16))
            if v["y"] > tol_y or v["dx"] > tol_dx or v["running"] > TOL_FP32 or v["flips_off_ties"]:
                bad.append(f"{dtype} {vs}: {v}")
    return bad


def check_bn_span(dev, gen):
    """K5's spanning mode at SPAN_SHAPE over SPAN_RANKS halves and at the
    real spanning shape SPAN_REAL (its whole batch over its ranks), relu, the
    partial sums added in place of the all-reduce: against whole-batch K5
    (its cluster design) and against its plain version, float32 and
    bfloat16, forward, running update and backward, reruns bit for bit,
    relu flips only at ties. bf16 device times of a rank's call through
    ``bn_span`` (autograd, forward + backward) beside the bound, the CUDA
    kernels a direction from the profiler (two), the cluster design at the
    rank's shape and one NCCL all-reduce of the partial sums (world 1)."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    c, ranks = SPAN_SHAPE[1], SPAN_RANKS
    b = SPAN_SHAPE[0] // ranks
    x = _layout(torch.randn(SPAN_SHAPE, generator=gen, device=dev) * 1.5 + 0.3)
    dy = _layout(torch.randn(SPAN_SHAPE, generator=gen, device=dev))
    rm, rv = 0.1 * torch.randn(c, generator=gen, device=dev), 0.5 + torch.rand(c, generator=gen, device=dev)
    layouts = [ops.SpanLayout.of(x[:b], SPAN_GROUPS, r, ranks) for r in range(ranks)]
    blocks = [slice(r * b, (r + 1) * b) for r in range(ranks)]
    errs = {str(dtype).split(".")[-1]: span_errors(x.to(dtype), dy.to(dtype), rm, rv, layouts,
                                                   blocks, SPAN_GROUPS)
            for dtype in (torch.float32, torch.bfloat16)}
    bad = span_failures(errs)
    if bad:
        fail(f"bn_train spanning mode at {SPAN_SHAPE}: {bad}")

    def rank_call(xh, dyh, lay, st):
        """A rank's BN call through the autograd entry: (forward, backward)."""
        def fwd():
            with torch.no_grad():
                return ops.bn_span(xh, st[0], st[1], lay, None, relu=True)

        def both():
            xi = xh.detach().requires_grad_(True)
            y = ops.bn_span(xi, st[0], st[1], lay, None, relu=True)
            return torch.autograd.grad(y, [xi], dyh)
        return fwd, both

    def rank_numbers(xh, dyh, lay, st):
        fwd, both = rank_call(xh, dyh, lay, st)
        kf, kb = cuda_kernels(fwd), cuda_kernels(both)
        nf = sum(kf.values())
        nb = sum(kb.values()) - nf
        if nf != 2 or nb != 2 or any("span_" not in k for k in kb):
            fail(f"bn_train span: CUDA kernels a call fwd {kf}, fwd + bwd {kb} (2 a direction)")
        # bytes, 5 units of one activation: the forward reads x and writes
        # y, the backward reads x and dy and writes dx (no y: the relu
        # decision is recomputed from x), x kept on chip across each
        # all-reduce
        bms, by = bound_ms(5 * xh.numel() * xh.element_size(), 20.0 * xh.numel(), torch.float32)
        return dict(kernels_fwd=nf, kernels_bwd=nb, kernel_names=sorted(kb),
                    device_ms=device_ms(both), device_ms_fwd=device_ms(fwd),
                    ms=time_ms(both), bound_ms=bms, bound_by=by)

    # a rank's calls in bf16 (the training dtype): its half, with its own sums
    xh, dyh = x[:b].bfloat16(), dy[:b].bfloat16()
    lay = layouts[0]
    st = [rm.clone(), rv.clone()]
    half = rank_numbers(xh, dyh, lay, st)
    # the plain version of a rank's half (no group: its own sums)
    plain = time_fwd_bwd(lambda t: ops.bn_span_reference(t, st[0], st[1], lay, None, relu=True),
                         [xh], dyh)
    # the cluster design at the rank's shape (its groups inside the rank)
    cfwd, cbwd = time_fwd_bwd(lambda t: ops.bn_train(t, st[0], st[1], groups=SPAN_GROUPS,
                                                     relu=True), [xh], dyh)

    def cluster_both():
        xi = xh.detach().requires_grad_(True)
        y = ops.bn_train(xi, st[0], st[1], groups=SPAN_GROUPS, relu=True)
        return torch.autograd.grad(y, [xi], dyh)
    cluster_dev = device_ms(cluster_both)

    lfwd, lbwd = time_fwd_bwd(
        lambda t: torch.relu(F.batch_norm(t, st[0].clone(), st[1].clone(), training=True,
                                          momentum=1 - ops.BN_MOMENTUM, eps=ops.BN_EPSILON)),
        [xh], dyh)
    del xh, dyh, x, dy
    # the real spanning shape: the whole batch of SPAN_REAL over its ranks
    real_shape, real_groups, real_ranks = SPAN_REAL
    rows = real_shape[0]
    xr = _layout(torch.randn((real_ranks * rows, *real_shape[1:]), generator=gen, device=dev)
                 * 1.5 + 0.3)
    dyr = _layout(torch.randn(xr.shape, generator=gen, device=dev))
    rr = [torch.zeros(real_shape[1], device=dev), torch.ones(real_shape[1], device=dev)]
    rlays = [ops.SpanLayout.of(xr[:rows], real_groups, r, real_ranks) for r in range(real_ranks)]
    rblocks = [slice(r * rows, (r + 1) * rows) for r in range(real_ranks)]
    real_err = {str(dtype).split(".")[-1]: span_errors(xr.to(dtype), dyr.to(dtype), *rr, rlays,
                                                       rblocks, real_groups)
                for dtype in (torch.float32, torch.bfloat16)}
    bad = span_failures(real_err)
    if bad:
        fail(f"bn_train span at {SPAN_REAL}: {bad}")
    xr, dyr = xr.bfloat16(), dyr.bfloat16()
    real = rank_numbers(xr[:rows], dyr[:rows], rlays[0], rr)
    real.update(shape=list(real_shape), groups=real_groups, ranks=real_ranks, errors=real_err)
    del xr, dyr
    # one all-reduce of the forward's sums and one of the backward's, on NCCL
    # at world size 1 (the card's machine has one GPU): the collective's
    # launch and copy at these sizes, not a transfer between cards
    sums = torch.zeros((SPAN_GROUPS, 2, c), device=dev)
    bsums = torch.zeros((SPAN_GROUPS, 2, c), device=dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        ar = time_ms(lambda: (dist.all_reduce(sums), dist.all_reduce(bsums)), reps=20)
    finally:
        dist.destroy_process_group()
    emit({"phase": "kernel", "name": "bn_train_span", "shape": list(SPAN_SHAPE), "ranks": ranks,
          "groups": SPAN_GROUPS, "errors": errs, "rank_half": half, "real_shape": real,
          "real_activation_mb": math.prod(real_shape) * 2 / 1e6,
          "cluster_ms_fwd": cfwd, "cluster_ms_bwd": cbwd, "allreduce_ms": ar})
    return dict(name="bn_train_span", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/bn_train.cu",
                replaces="voxsrc2020_speaker_verification_tpu/ops/nn.py:117 (_GroupedBN with "
                         "bn_groups across the data axis of make_mesh, GSPMD, forward and "
                         "backward)",
                max_abs_err=max(errs["bfloat16"][vs][k] for vs in ("vs_whole_k5", "vs_plain")
                                for k in ("y", "dx")),
                errors=errs, tolerance=TOL_TRAIN_BF16,
                dtype="bfloat16", per=f"one rank's half {[b, *SPAN_SHAPE[1:]]} of "
                f"{list(SPAN_SHAPE)}, groups {SPAN_GROUPS}, relu, forward + backward",
                ms=half["ms"], device_ms=half["device_ms"], plain_ms=sum(plain),
                bound_ms=half["bound_ms"], bound_by=half["bound_by"],
                kernels_a_direction={"fwd": half["kernels_fwd"], "bwd": half["kernels_bwd"]},
                real_shape=real, allreduce_ms=ar,
                allreduce_note="two NCCL all-reduces a step (forward and backward sums), "
                               "world size 1 on one card",
                cluster_design_ms=cfwd + cbwd, cluster_design_device_ms=cluster_dev,
                cluster_design_note="K5's cluster design at the rank's shape, its groups "
                                    "inside the rank",
                library_ms=lfwd + lbwd,
                library_note="F.batch_norm (training) + relu at the rank's shape: the rank's "
                             "own statistics, no collective")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_margin_partial(dev, gen):
    """K6's class-sharded mode at MARGIN_SPLIT over two class ranges (the
    partials combined as the all-reduce combines them) against whole-class
    K6: loss, correct flags, lse and each range's dcos; a shard's times."""
    from voxsrc2020_speaker_verification_tpu_torch.losses.projections import (
        combine_partials, margin_ce, margin_ce_partial_grad, margin_ce_partials,
        margin_ce_sharded_reference)

    k, bsz, c = MARGIN_SPLIT
    cut = c // 2
    cos = (torch.rand(MARGIN_SPLIT, generator=gen, device=dev) * 2 - 1) * 0.998
    labels = torch.randint(0, c, (bsz,), generator=gen, device=dev)
    dloss = torch.rand(bsz, generator=gen, device=dev) / bsz
    ci = cos.clone().requires_grad_(True)
    loss, correct = margin_ce(ci, labels, 32.0, 0.2)
    loss.backward(dloss)
    shards = [(0, cos[:, :, :cut].contiguous()), (cut, cos[:, :, cut:].contiguous())]
    parts = torch.stack([margin_ce_partials(x, labels, 32.0, 0.2, off) for off, x in shards])
    ploss, pcorrect, lse = combine_partials(parts, labels)
    dcos = torch.cat([margin_ce_partial_grad(x, labels, lse, dloss, 32.0, 0.2, off)
                      for off, x in shards], dim=2)
    err = max(rel_err(ploss, loss.detach()), rel_err(dcos, ci.grad))
    if err > TOL_FP32 or not torch.equal(pcorrect, correct):
        fail(f"margin_ce partial mode: rel err {err}, correct equal "
             f"{torch.equal(pcorrect, correct)}")
    off, shard = shards[1]
    fwd = time_ms(lambda: margin_ce_partials(shard, labels, 32.0, 0.2, off))
    bwd = time_ms(lambda: margin_ce_partial_grad(shard, labels, lse, dloss, 32.0, 0.2, off))
    dev_fwd = device_ms(lambda: margin_ce_partials(shard, labels, 32.0, 0.2, off),
                        "margin_ce_fwd_kernel")
    dev_bwd = device_ms(lambda: margin_ce_partial_grad(shard, labels, lse, dloss, 32.0, 0.2,
                                                       off), "margin_ce_bwd_kernel")
    plain = time_fwd_bwd(
        lambda t: margin_ce_sharded_reference(t, labels, 32.0, 0.2, off, None)[0], [shard], dloss)
    bms, by = bound_ms(3 * 4 * shard.numel(), 30.0 * shard.numel(), torch.float32)
    emit({"phase": "kernel", "name": "margin_ce_partial", "shape": list(MARGIN_SPLIT),
          "shard": list(shard.shape), "ms_fwd": fwd, "ms_bwd": bwd})
    return dict(name="margin_ce_partial", route="cuda",
                source="voxsrc2020_speaker_verification_tpu_torch/csrc/margin_ce.cu",
                replaces="voxsrc2020_speaker_verification_tpu/losses/projections.py:96 "
                         "(sc_cm_linear + CE with the kernel sharded over the model axis, "
                         "parallel/sharding.py:46, GSPMD)",
                max_abs_err=err, tolerance=TOL_FP32, dtype="float32",
                per=f"one class shard {list(shard.shape)} of {list(MARGIN_SPLIT)}, forward + "
                    f"backward", ms=fwd + bwd, device_ms=dev_fwd + dev_bwd,
                plain_ms=sum(plain), bound_ms=bms, bound_by=by, library_ms=None,
                library_note="none: no single PyTorch call does max over centers, margin and "
                             "a partial log-sum-exp")


def single_chip_phase(dev, workdir, smi):
    """cli.train --single-chip with the reference's best system: the shape
    the table gives (fails otherwise), its peak memory and step time."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels
    from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe, single_chip_shape

    want = single_chip_shape(SINGLE_CHIP_MODEL, TRAIN_FRAMES)
    argv = ["--recipe", "res2net_vox2_dev_aug", "--model", SINGLE_CHIP_MODEL, "--single-chip",
            "--synthetic", "--max-steps", str(SINGLE_CHIP_STEPS), "--log-every", "1",
            "--no-checkpoint", "--exp-root", os.path.join(workdir, "single_chip"),
            "--seed", str(SEED)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = train_cli.main(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.function_launch_counts()
    printed = [line for line in out.getvalue().splitlines() if line.startswith("single-chip")]
    hist = run.result.history
    cfg = get_recipe("res2net_vox2_dev_aug", model=SINGLE_CHIP_MODEL, single_chip=True)[0]
    got = dict(batch_size=cfg.batch_size, num_accumulation_steps=cfg.num_accumulation_steps,
               remat=cfg.remat, remat_stages=cfg.remat_stages, bn_groups=cfg.bn_groups)
    if not want or got != want or not printed or len(hist) != SINGLE_CHIP_STEPS:
        fail(f"single_chip: shape {got} vs table {want}, printed {printed}, {len(hist)} steps")
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail("single_chip: non-finite loss")
    # K5 and K9 / K9b per microbatch, the recompute of the rematerialized
    # stages included
    per_microbatch, _ = k5_calls(cfg, cfg.remat_stages if cfg.remat else None)
    microbatches = SINGLE_CHIP_STEPS * cfg.num_accumulation_steps
    bad = {fn: (counts[fn], microbatches * n) for fn, n in per_microbatch.items()
           if counts[fn] != microbatches * n}
    if bad:
        fail(f"single_chip: launches (counted, expected) {bad}")
    step_ms = 1e3 * (hist[-1]["time"] - hist[-2]["time"])
    del run
    emit({"phase": "single_chip", "model": SINGLE_CHIP_MODEL, "shape": got, "printed": printed,
          "launches_per_microbatch": per_microbatch, "peak_memory_bytes": peak, "peak_gb": peak / 1e9, "step_ms": step_ms,
          "audio_s_per_s": 1024 * TRAIN_FRAMES / 100.0 / (step_ms / 1e3),
          "losses": [h["loss"] for h in hist], "card": smi})


def _launch(workdir, name, nprocs, extra, timeout=LAUNCH_TIMEOUT_S):
    """cli.launch of ``nprocs`` cli.train processes (one step of LAUNCH_*);
    returns (exp dir, [each rank's output])."""
    run_dir = os.path.join(workdir, name)
    os.makedirs(run_dir, exist_ok=True)
    exp_root = os.path.join(run_dir, "exp")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "voxsrc2020_speaker_verification_tpu_torch.cli.launch",
           "--num-processes", str(nprocs), "--coordinator", f"localhost:{_free_port()}", "--",
           *_launch_args(exp_root), "--print-kernel-launches", *extra]
    proc = subprocess.run(cmd, cwd=run_dir, env=env, capture_output=True, text=True,
                          timeout=timeout)
    outs = [proc.stdout]
    for i in range(1, nprocs):
        with open(os.path.join(run_dir, f"launch_rank{i}.log")) as f:
            outs.append(f.read())
    if proc.returncode != 0:
        fail(f"launch {name}: rc {proc.returncode}\n{proc.stderr[-3000:]}\n"
             + "\n".join(o[-2000:] for o in outs))
    exp = [d for d, _, files in os.walk(exp_root) if "metrics.jsonl" in files]
    if len(exp) != 1:
        fail(f"launch {name}: experiment dirs {exp}")
    return exp[0], outs


def _launch_args(exp_root):
    return ["--recipe", "res2net_vox2_dev_aug", "--model", LAUNCH_MODEL, "--synthetic",
            "--float32", "--batch-size", str(LAUNCH_BATCH), "--num-accumulation-steps",
            str(LAUNCH_ACCUM), "--bn-groups", str(LAUNCH_GROUPS), "--max-steps", "1",
            "--log-every", "1", "--num-workers", "1", "--seed", str(SEED),
            "--exp-root", exp_root]


def _run_state(exp):
    from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import FILE

    from voxsrc2020_speaker_verification_tpu_torch.utils.observability import load_metrics

    steps = sorted(int(d) for d in os.listdir(exp) if d.isdigit())
    saved = torch.load(os.path.join(exp, str(steps[-1]), FILE), map_location="cpu",
                       weights_only=True)
    return load_metrics(exp), saved


def _l2(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every tensor of two name -> tensor maps."""
    num = sum(float(torch.sum(torch.square(a[k].double() - v.double()))) for k, v in b.items())
    return math.sqrt(num / sum(float(torch.sum(torch.square(v.double()))) for v in b.values()))


def launch_noise_floor(dev, config, one, one_metrics):
    """The float32 noise of the one-process step: the same step on the card
    with the rows of each microbatch permuted (reversed, rolled by half,
    evens then odds: the same function with LAUNCH_GROUPS = 1, one BN group
    and a mean loss, in other summation orders), the largest distance of
    the three to the CLI's one-process run. The step at step 0 has lr 0,
    so its update is read off the momentum it leaves (the clipped gradient;
    lr times it at a later step)."""
    from voxsrc2020_speaker_verification_tpu_torch.data.dataset import (
        BatchFeeder, SyntheticDataset)
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        create_train_state, make_train_step)

    feeder = BatchFeeder([SyntheticDataset(config.feat_dim, config.feat_length,
                                           config.num_classes, seed=SEED)],
                         config.batch_size, config.num_accumulation_steps).start()
    try:
        feats, labels = next(iter(feeder))
    finally:
        feeder.stop()
    if config.bn_groups != 1:
        fail("launch: the noise floor permutes rows, which needs one BN group")
    b = config.batch_size
    floor = {"update": 0.0, "gradient_norm": 0.0}
    for perm in (torch.arange(b - 1, -1, -1), torch.roll(torch.arange(b), b // 2),
                 torch.cat([torch.arange(0, b, 2), torch.arange(1, b, 2)])):
        state = create_train_state(config, dev)
        state, m = make_train_step(config)(state, torch.from_numpy(feats)[:, perm].to(dev),
                                           torch.from_numpy(labels)[:, perm].long().to(dev))
        mom = {k: v.cpu() for k, v in state.momentum.items()}
        floor["update"] = max(floor["update"], _l2(mom, one["momentum"]))
        floor["gradient_norm"] = max(floor["gradient_norm"], abs(
            float(m["gradient_norm"]) - one_metrics[-1]["gradient_norm"])
            / one_metrics[-1]["gradient_norm"])
        del state
    return floor


def launch_phase(dev, workdir, smi):
    """cli.launch on the one card: data 2 (BN groups spanning the ranks) and
    model 2 (the head's classes split), two gloo processes each, one
    float32 step; each run's metrics.jsonl and checkpoint against one
    process on the same rows: loss and BN statistics within TOL_PARITY, the
    update (the momentum: lr is 0 at step 0) and the gradient norm no
    further from it than twice the one-process step's own float32 noise
    (launch_noise_floor) plus TOL_PARITY, as train_parity holds them; each
    rank's launches of K5's spanning path and K6's partial path; then a
    one-rank NCCL launch."""
    from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig

    one_root = os.path.join(workdir, "launch_one", "exp")
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(_launch_args(one_root))
    one_exp = [d for d, _, files in os.walk(one_root) if "metrics.jsonl" in files][0]
    one_metrics, one = _run_state(one_exp)
    config = TrainConfig.from_json(os.path.join(one_exp, "config.json"))
    floor = launch_noise_floor(dev, config, one, one_metrics)
    runs = {}
    for name, extra, want_fns in (
            ("data2", [], ("bn_train.bn_span_stats", "bn_train.bn_span_normalize",
                           "bn_train.bn_span_bwd_reduce", "bn_train.bn_span_bwd_grad")),
            ("model2", ["--num-model-shards", "2"], ("margin_ce.margin_ce_partial_fwd:slab",
                                                     "margin_ce.margin_ce_partial_bwd:slab"))):
        t0 = time.perf_counter()
        exp, outs = _launch(workdir, name, 2, extra)
        wall = time.perf_counter() - t0
        metrics, saved = _run_state(exp)
        backend = [line for line in outs[0].splitlines() if line.startswith("distributed:")]
        launches = [json.loads(line.split(":", 1)[1]) for o in outs for line in o.splitlines()
                    if line.startswith("kernel launches:")]
        losses = [line.split("loss")[1].split()[0] for o in outs for line in o.splitlines()
                  if line.startswith("step 1/")]
        # the stride-1 chains: the span route where BN groups span the ranks
        # (data2: F.conv2d + K5's spanning mode), K9 / K9b where they do not
        k9 = [sum(v for k, v in rank.items() if k.startswith("split_train.")) for rank in launches]
        # the stride-2 stages likewise: the route in data2, K11 / K11b in model2
        k11 = [sum(v for k, v in rank.items() if k.startswith("split_stride2_train."))
               for rank in launches]
        if (len(launches) != 2 or any(not all(rank.get(f, 0) for f in want_fns)
                                      for rank in launches)
                or any((n > 0) != (name == "model2") for n in k9 + k11)
                or not backend or "gloo" not in backend[0] or len(set(losses)) != 1):
            fail(f"launch {name}: backend {backend}, losses {losses}, launches {launches}")
        err = {k: abs(metrics[-1][k] - one_metrics[-1][k]) / max(abs(one_metrics[-1][k]), 1e-12)
               for k in ("loss", "gradient_norm")}
        err["update"] = _l2(saved["momentum"], one["momentum"])
        err["batch_stats"] = max(float((saved["batch_stats"][k] - v).abs().max()
                                       / v.abs().max().clamp(min=1e-3))
                                 for k, v in one["batch_stats"].items())
        bad = {k: err[k] for k in ("loss", "batch_stats") if not err[k] <= TOL_PARITY[k]}
        bad.update({k: err[k] for k in ("update", "gradient_norm")
                    if not err[k] <= 2 * floor[k] + TOL_PARITY[k]})
        if bad:
            fail(f"launch {name} vs one process: {err}, the one-process step's own float32 "
                 f"noise {floor} (TOL_PARITY {TOL_PARITY})")
        runs[name] = dict(backend=backend[0], errors_vs_one_process=err,
                          one_process_fp32_noise=floor, seconds=wall,
                          launches_by_rank=[{f: rank.get(f, 0) for f in want_fns}
                                            for rank in launches],
                          k9_launches_by_rank=k9, k11_launches_by_rank=k11,
                          loss=metrics[-1]["loss"])
    # data 2 at bn_groups 2: every BN group inside a rank, so the split
    # stages run K9 / K9b and K11 / K11b with groups / ranks = 1 and no BN
    # launches K5's spanning mode
    t0 = time.perf_counter()
    _, outs = _launch(workdir, "data2_g2", 2, ["--bn-groups", "2"])
    launches = [json.loads(line.split(":", 1)[1]) for o in outs for line in o.splitlines()
                if line.startswith("kernel launches:")]
    by_rank = [{k: v for k, v in rank.items()
                if k.startswith(("split_stride2_train.", "split_train.", "bn_train.bn_span"))}
               for rank in launches]
    if len(launches) != 2 or any(
            not all(rank.get(k, 0) for k in K11_FNS) or not rank.get("split_train.split_train_fwd")
            or any(v for k, v in rank.items() if k.startswith("bn_train.bn_span"))
            for rank in by_rank):
        fail(f"launch data2_g2: launches {by_rank}")
    runs["data2_g2"] = dict(seconds=time.perf_counter() - t0, bn_groups=2,
                            split_stage_launches_by_rank=by_rank)
    exp, outs = _launch(workdir, "nccl1", 1, [])
    backend = [line for line in outs[0].splitlines() if line.startswith("distributed:")]
    if not backend or "nccl" not in backend[0]:
        fail(f"launch nccl1: backend {backend}")
    runs["nccl1"] = dict(backend=backend[0])
    emit({"phase": "launch", "model": LAUNCH_MODEL, "batch": LAUNCH_BATCH,
          "accumulation": LAUNCH_ACCUM, "bn_groups": LAUNCH_GROUPS, "dtype": "float32",
          "runs": runs, "tolerance": TOL_PARITY, "card": smi})
    return runs


def trace_phase(dev, config, workdir):
    """Two resident steps of the train phase's config (a fresh state) under
    observability.trace: the Chrome trace under <exp>/profile must name
    K5's and K6's kernels; the same steps untraced beside them."""
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        create_train_state, make_train_step)
    from voxsrc2020_speaker_verification_tpu_torch.utils.observability import trace

    exp = os.path.join(workdir, "trace_exp")
    state = create_train_state(config, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    feats = torch.randn((TRAIN_ACCUM, TRAIN_BATCH, TRAIN_FRAMES, FEAT_DIM), generator=g,
                        device=dev)
    labels = torch.randint(0, config.num_classes, (TRAIN_ACCUM, TRAIN_BATCH), generator=g,
                           device=dev)
    step = make_train_step(config)
    state, _ = step(state, feats, labels)
    t0 = time.perf_counter()
    with trace(exp, name="train_steps") as prof:
        for _ in range(TRACE_STEPS):
            state, _ = step(state, feats, labels)
    traced_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRACE_STEPS):
        state, _ = step(state, feats, labels)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not prof.trace_path.startswith(os.path.join(exp, "profile")):
        fail(f"trace: written to {prof.trace_path}")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in names if k in n)
             for k in ("cluster_fwd_kernel", "cluster_bwd_kernel", "margin_ce_fwd_kernel",
                       "margin_ce_bwd_kernel")}
    if not all(found.values()):
        fail(f"trace: kernels named {sorted(names)[:40]}")
    emit({"phase": "trace", "path_under_exp": os.path.relpath(prof.trace_path, exp),
          "bytes": os.path.getsize(prof.trace_path), "kernel_names": found,
          "device_kernels": len([e for e in events if e.get("cat") == "kernel"]),
          "traced_ms_per_step": 1e3 * traced_s / TRACE_STEPS,
          "untraced_ms_per_step": 1e3 * plain_s / TRACE_STEPS})


# slice 13: data preparation (cli.prepare_data stages 2, 4, 5 through K1),
# the reference TF checkpoint import at full width, extraction over devices
PREP_SPEAKERS, PREP_UTTS, PREP_SECONDS = 16, 8, (3.0, 8.0)
PREP_RIR_SAMPLES, PREP_SUBSET = (200, 400), 8
IMPORT_MODEL, IMPORT_STEP, IMPORT_RECIPE = "res2net50_w24_s4_c32", 122636, "res2net_vox2_dev_aug"
IMPORT_TRAIN_BATCH = 64
MULTI_BATCH = 128  # the w24 model's extraction bucket batch (eval/extract.py)


def write_prepare_corpora(root, seed):
    """The prepare phase's corpora (see the module docstring): a wav tree
    (speaker/video/utterance.wav), a MUSAN tree and simulated RIRs with
    rir_list metadata. Returns (wav root, musan root, rirs root, seconds of
    the wav tree)."""
    from voxsrc2020_speaker_verification_tpu_torch.data import audio

    rng = np.random.RandomState(seed)
    wav_root, musan, rirs = (os.path.join(root, d) for d in ("wav", "musan", "RIRS_NOISES"))
    seconds = 0.0
    for s in range(PREP_SPEAKERS):
        bank = speaker_bank(rng)
        for i in range(PREP_UTTS):
            d = os.path.join(wav_root, f"id2{s:04d}", f"vid{i % 3}")
            os.makedirs(d, exist_ok=True)
            n = int(rng.uniform(*PREP_SECONDS) * 10)
            units = bank[rng.randint(len(bank), size=n)] * rng.uniform(0.3, 1.0, (n, 1))
            audio.write_wav(os.path.join(d, f"{i:05d}.wav"), units.reshape(-1))
            seconds += n / 10.0
    for sub, count in (("noise", 4), ("speech", 6), ("music", 3)):
        d = os.path.join(musan, sub, "src")
        os.makedirs(d)
        for i in range(count):
            n = int(rng.uniform(2.0, 6.0) * 16000)
            if sub == "noise":
                x = rng.randn(n) * 1500.0
            elif sub == "speech":
                b = speaker_bank(rng, 16)
                x = (b[rng.randint(16, size=n // 1600)] * 0.8).reshape(-1)
            else:
                t = np.arange(n) / 16000.0
                x = sum(np.sin(2 * np.pi * f * t) for f in rng.uniform(110, 880, 3)) * 1500.0
            audio.write_wav(os.path.join(d, f"{sub}-{i:04d}.wav"), np.asarray(x, np.float32))
    with open(os.path.join(musan, "music", "src", "ANNOTATIONS"), "w") as f:
        f.write("".join(f"music-{i:04d} genre {'Y' if i == 2 else 'N'}\n" for i in range(3)))
    for room in ("smallroom", "mediumroom"):
        lines = []
        for r in range(3):
            d = os.path.join(rirs, "simulated_rirs", room, f"Room{r:03d}")
            os.makedirs(d)
            for k in range(2):
                n = int(rng.randint(*PREP_RIR_SAMPLES))
                rir = rng.randn(n) * np.exp(-np.arange(n) / (n / 6.0))
                rir[rng.randint(5, 20)] = 4.0
                path = os.path.join(d, f"{room}-{r}-{k}.wav")
                audio.write_wav(path, (rir * 6000.0).astype(np.float32))
                lines.append(f"--rir-id {room}-{r}-{k} --room-id {room}-{r} "
                             f"RIRS_NOISES/simulated_rirs/{room}/Room{r:03d}/{room}-{r}-{k}.wav")
        with open(os.path.join(rirs, "simulated_rirs", room, "rir_list"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return wav_root, musan, rirs, seconds


def k1_batches(samples_by_utt, batch=16):
    """K1's launches over a data dir (data/features.py:wave_feature_batches:
    utterances by audio-length bucket, batches of ``batch``)."""
    from voxsrc2020_speaker_verification_tpu_torch.data.features import DEFAULT_BUCKETS_S

    per = {}
    for n in samples_by_utt.values():
        b = next((b for b in DEFAULT_BUCKETS_S if n <= b * 16000), DEFAULT_BUCKETS_S[-1])
        per[b] = per.get(b, 0) + 1
    return sum(-(-c // batch) for c in per.values())


def cm_bound(feats):
    """Kaldi CM compression's coarsest step over these matrices: the global
    range over 65535 (header) plus over 255 (an 8-bit code)."""
    lo = min(float(m.min()) for m in feats.values())
    hi = max(float(m.max()) for m in feats.values())
    return (hi - lo) / 65535.0 + (hi - lo) / 255.0


def prepare_phase(dev, workdir, smi):
    """cli.prepare_data stages 2, 4 and 5 on the card (see the module
    docstring). Returns (the dev data dir, its audio seconds, K1's launches
    in stages 4 and 5)."""
    from voxsrc2020_speaker_verification_tpu_torch.cli import prepare_data as prep_cli
    from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
    from voxsrc2020_speaker_verification_tpu_torch.data.features import utterance_loader
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb
    from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

    root = os.path.join(workdir, "prepare")
    t0 = time.perf_counter()
    wav_root, musan, rirs, dev_seconds = write_prepare_corpora(root, SEED + 51)
    write_s = time.perf_counter() - t0
    data_root = os.path.join(root, "data")
    common = ["--data-root", data_root, "--dataset", "voxceleb2_dev", "--feat-dim",
              str(FEAT_DIM), "--num-shards", "4", "8"]
    legs = {}
    for stage, extra in ((2, ["--wav-root", wav_root]), (4, []),
                         (5, ["--musan-root", musan, "--rirs-root", rirs])):
        out, text, sec, counts = timed_leg(prep_cli.main, ["--stage", str(stage), *common, *extra])
        legs[stage] = dict(dir=out, seconds=sec, counts=counts, printed=text.strip()[-300:])
    dev_dir, aug_dir = legs[2]["dir"], legs[5]["dir"]
    problems = {d: datadir.validate_data_dir(d) for d in (dev_dir, aug_dir)}
    # each utterance's samples from its wav header (a spec renders to its
    # source's length)
    import wave
    samples = {}
    for d in (dev_dir, aug_dir):
        samples[d] = {}
        for u, v in datadir.read_two_column(os.path.join(d, "wav.scp")).items():
            path = json.loads(v)["source"] if v.startswith("{") else v
            with wave.open(path) as w:
                samples[d][u] = w.getnframes()
    want_k1 = {4: k1_batches(samples[dev_dir]), 5: k1_batches(samples[aug_dir])}
    got_k1 = {s: legs[s]["counts"]["fbank"] for s in (4, 5)}
    aug_seconds = sum(samples[aug_dir].values()) / 16000.0
    if any(problems.values()) or len(samples[aug_dir]) != 5 * len(samples[dev_dir]):
        fail(f"prepare: data dir problems {problems}, {len(samples[aug_dir])} aug utterances")
    if got_k1 != want_k1 or legs[2]["counts"]["fbank"]:
        fail(f"prepare: K1 launches {got_k1}, expected {want_k1} (stage 2: "
             f"{legs[2]['counts']['fbank']})")

    # a subset of the _aug store: the waves rendered as stage 5 rendered
    # them, K1 on the card against its plain version and float64 (the raw
    # phase's rule), and the store against K1's features within CM's step
    load, renderer = utterance_loader()
    wav = datadir.read_two_column(os.path.join(aug_dir, "wav.scp"))
    store = kaldi_io.read_all(kaldi_io.read_mat_scp(os.path.join(aug_dir, f"fbank{FEAT_DIM}.scp")))
    cfg = fb.FbankConfig(num_bins=FEAT_DIM, dither=0.0)
    subset = sorted(wav)[:PREP_SUBSET]
    errs, store_err, k1_feats = [], 0.0, {}
    with torch.inference_mode():
        for u in subset:
            x = torch.from_numpy(fb.pcm16(load(wav[u])[0]).astype(np.float32))[None].to(dev)
            got = fb.fbank(x, cfg)
            errs.append(hold_fp32(f"prepare K1 ({u})", "crops", got,
                                  fb.fbank_reference(x, cfg), fbank_float64(x, cfg)))
            k1_feats[u] = got[0].cpu().numpy()
    bound = cm_bound(store)
    for u in subset:
        if store[u].shape != k1_feats[u].shape:
            fail(f"prepare: store {u} {store[u].shape} vs K1 {k1_feats[u].shape}")
        store_err = max(store_err, float(np.abs(store[u] - k1_feats[u]).max()))
    if store_err > bound:
        fail(f"prepare: store vs K1 {store_err} beyond CM's step {bound}")
    emit({"phase": "prepare", "utterances": len(samples[dev_dir]),
          "aug_utterances": len(samples[aug_dir]), "audio_s": dev_seconds,
          "aug_audio_s": aug_seconds, "write_s": write_s, "renderer": renderer,
          "stage_seconds": {s: legs[s]["seconds"] for s in legs},
          "stage4_audio_s_per_s": dev_seconds / legs[4]["seconds"],
          "stage5_audio_s_per_s": aug_seconds / legs[5]["seconds"],
          "k1_launches": got_k1, "subset": subset,
          "k1_vs_plain_max": max(e["vs_plain"] for e in errs),
          "k1_vs_float64_max": max(e["vs_float64"] for e in errs),
          "plain_vs_float64_max": max(e["plain_vs_float64"] for e in errs),
          "store_vs_k1_max": store_err, "cm_step": bound, "tolerance": TOL_FBANK,
          "note": "stage 5: MUSAN dirs, 5x specs, rendering and K1; audio_s_per_s is "
                  "audio seconds over the stage's wall time", "card": smi})
    return dev_dir, dev_seconds, {s: legs[s]["counts"] for s in (4, 5)}


def import_phase(dev, workdir, smi, store_dir, store_seconds):
    """The full-width import (see the module docstring). Returns (the
    imported artifact, launches of its extraction)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import tf_bundle_writer

    from voxsrc2020_speaker_verification_tpu_torch.cli import export as export_cli
    from voxsrc2020_speaker_verification_tpu_torch.cli import extract as extract_cli
    from voxsrc2020_speaker_verification_tpu_torch.cli import import_checkpoint as import_cli
    from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
    from voxsrc2020_speaker_verification_tpu_torch.convert import init_weights
    from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import save_inference_artifact
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe
    from voxsrc2020_speaker_verification_tpu_torch.utils.tf_import import load_tf_checkpoint

    root = os.path.join(workdir, "import")
    exp_root = os.path.join(root, "exp")
    config, _ = get_recipe(IMPORT_RECIPE, model=IMPORT_MODEL, exp_root=exp_root)
    gen = torch.Generator().manual_seed(SEED + 61)
    weights = init_weights(config, gen, projection=True)
    momentum = {k: torch.randn(v.shape, generator=gen) * 0.01 for k, v in weights.items()
                if not k.endswith(("running_mean", "running_var"))}
    snap = tf_bundle_writer.reference_snapshot(weights, IMPORT_MODEL, momentum=momentum,
                                               step=IMPORT_STEP)
    prefix = os.path.join(root, "tf", f"model.ckpt-{IMPORT_STEP}")
    t0 = time.perf_counter()
    data_bytes = tf_bundle_writer.write_bundle(prefix, snap)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read = load_tf_checkpoint(prefix)
    read_s = time.perf_counter() - t0
    if read.keys() != snap.keys() or not all(np.array_equal(read[k], v) for k, v in snap.items()):
        fail("import: the bundle reader's values differ from what was written")
    del read

    legs = {}
    for name, fn, argv in (
            ("import", import_cli.main, ["--ckpt", prefix, "--model", IMPORT_MODEL,
                                         "--projection", "sc_cm_linear", "--num-classes", "5994",
                                         "--recipe", IMPORT_RECIPE, "--exp-dir", config.exp_dir]),
            ("export", export_cli.main, ["--exp-dir", config.exp_dir, "--batch-size", "32"]),
            ("extract", extract_cli.main, None)):
        if name == "extract":
            argv = ["--artifact", legs["export"]["out"], "--data-dir", store_dir,
                    "--out", os.path.join(root, "xv_imported")]
        out, text, sec, counts = timed_leg(fn, argv)
        legs[name] = dict(out=out, text=text.strip()[-400:], seconds=sec, counts=counts)
    artifact = legs["export"]["out"]
    imported = dict(kaldi_io.read_vec_flt_scp(legs["extract"]["out"]))
    # the original weights, saved straight into an artifact, through the same CLI
    direct = save_inference_artifact(
        config, {k: v for k, v in weights.items() if k.startswith("encoder.")},
        os.path.join(root, "direct"), step=IMPORT_STEP)
    with contextlib.redirect_stdout(io.StringIO()):
        direct_scp = extract_cli.main(["--artifact", direct, "--data-dir", store_dir,
                                       "--out", os.path.join(root, "xv_direct")])
    want = dict(kaldi_io.read_vec_flt_scp(direct_scp))
    w_imp = torch.load(os.path.join(artifact, "weights.pt"), weights_only=True)
    same_weights = all(torch.equal(w_imp[k], weights[k]) for k in w_imp) and len(w_imp) == len(
        [k for k in weights if k.startswith("encoder.")])
    cos_min = min_cos(want, imported)
    max_abs = max(float(np.abs(imported[u] - want[u]).max()) for u in want)
    if not same_weights or cos_min < TOL_EXTRACT_COS or legs["extract"]["counts"]["split_conv"] == 0:
        fail(f"import: weights equal {same_weights}, imported vs direct min cosine {cos_min}, "
             f"launches {legs['extract']['counts']}")

    # one resumed step: its step is global_step + 1, its momentum the slots'
    ckpt = os.path.join(config.exp_dir, str(IMPORT_STEP), "train_state.pt")
    before = torch.load(ckpt, map_location="cpu", weights_only=True)["momentum"]
    if not all(torch.equal(before[k], momentum[k]) for k in momentum):
        fail("import: the checkpoint's momentum is not the imported slots")
    argv = ["--recipe", IMPORT_RECIPE, "--model", IMPORT_MODEL, "--synthetic",
            "--exp-root", exp_root, "--batch-size", str(IMPORT_TRAIN_BATCH),
            "--num-accumulation-steps", "1", "--max-steps", "1", "--log-every", "1",
            "--seed", str(SEED)]
    run, _, train_s, train_counts = timed_leg(train_cli.main, argv)
    hist = run.result.history
    after_path = os.path.join(config.exp_dir, str(IMPORT_STEP + 1), "train_state.pt")
    if [h["step"] for h in hist] != [IMPORT_STEP + 1] or not os.path.exists(after_path):
        fail(f"import: resumed steps {[h['step'] for h in hist]}, expected {IMPORT_STEP + 1}")
    after = torch.load(after_path, map_location="cpu", weights_only=True)["momentum"]
    # trace-form momentum: m' = 0.9 m + g with |g| <= clip_norm after the clip
    resid = math.sqrt(sum(float(((after[k] - config.momentum * before[k]).double() ** 2).sum())
                          for k in before))
    norm_before = math.sqrt(sum(float((v.double() ** 2).sum()) for v in before.values()))
    if not math.isfinite(hist[0]["loss"]) or resid > config.clip_norm * (1 + 1e-3):
        fail(f"import: resumed step loss {hist[0]['loss']}, |m' - 0.9 m| {resid} "
             f"(|m| {norm_before}, clip {config.clip_norm})")
    del run
    mb = data_bytes / 1e6
    reader_rate = [line for line in legs["import"]["text"].splitlines() if "MB/s" in line]
    emit({"phase": "import", "model": IMPORT_MODEL, "classes": 5994, "centers": 2,
          "variables": len(snap), "bundle_mb": mb, "index_bytes": os.path.getsize(prefix + ".index"),
          "write_s": write_s, "read_s": read_s, "reader_mb_per_s_host": mb / read_s,
          "cli_reader": reader_rate,
          "leg_seconds": {k: v["seconds"] for k, v in legs.items()},
          "import_export_extract_s": sum(v["seconds"] for v in legs.values()),
          "extract_audio_s_per_s": store_seconds / legs["extract"]["seconds"],
          "imported_vs_direct": {"min_cos": cos_min, "max_abs": max_abs,
                                 "tolerance": TOL_EXTRACT_COS},
          "resumed_step": hist[0]["step"], "resumed_loss": hist[0]["loss"],
          "momentum_residual": resid, "momentum_norm_before": norm_before,
          "train_s": train_s, "launches_extract": legs["extract"]["counts"],
          "launches_train": {k: v for k, v in train_counts.items() if v},
          "note": "reader MB/s is the host's (load_tf_checkpoint of the written bundle)",
          "card": smi})
    return artifact, legs["extract"]["counts"]


def multi_device_phase(dev, workdir, smi, artifact, store_dir, store_seconds):
    """Extraction over [cuda:0, cuda:0] (two replicas on the one card, each
    bucket batch split in two) against one device at the half batch (bit
    for bit) and at the whole batch (cosines); --num-devices beyond the
    cards present must fail. Returns the launches of the sharded leg."""
    from voxsrc2020_speaker_verification_tpu_torch.cli import extract as extract_cli
    from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io

    root = os.path.join(workdir, "multi_device")
    os.makedirs(root)
    legs = {}
    for name, devices, batch in (("two_replicas", [dev, dev], MULTI_BATCH),
                                 ("one_half_batch", [dev], MULTI_BATCH // 2),
                                 ("one_whole_batch", [dev], MULTI_BATCH),
                                 ("two_replicas_again", [dev, dev], MULTI_BATCH)):
        scp, _, sec, counts = timed_leg(lambda d=devices, b=batch, n=name: extract_cli.extract_dataset(
            artifact, store_dir, os.path.join(root, n), batch_size=b, devices=d))
        legs[name] = dict(vectors=dict(kaldi_io.read_vec_flt_scp(scp)), seconds=sec,
                          counts=counts, audio_s_per_s=store_seconds / sec)
    two, half, whole = (legs[k]["vectors"] for k in ("two_replicas", "one_half_batch",
                                                     "one_whole_batch"))
    bit_equal = sorted(two) == sorted(half) and all(np.array_equal(two[u], half[u]) for u in half)
    rerun_equal = all(np.array_equal(two[u], legs["two_replicas_again"]["vectors"][u]) for u in two)
    cos_whole = min_cos(whole, two)
    present = torch.cuda.device_count()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            extract_cli.main(["--artifact", artifact, "--data-dir", store_dir,
                              "--out", os.path.join(root, "refused"),
                              "--num-devices", str(present + 1)])
        refused = None
    except ValueError as e:
        refused = str(e)
    if not bit_equal or not rerun_equal or cos_whole < TOL_EXTRACT_COS:
        fail(f"multi_device: two replicas vs one device at the half batch bit-equal {bit_equal}, "
             f"rerun {rerun_equal}, vs the whole batch min cosine {cos_whole}")
    if not refused or "more cards than present" not in refused:
        fail(f"multi_device: --num-devices {present + 1} on {present} card(s) gave {refused!r}")
    emit({"phase": "multi_device", "devices": [str(dev), str(dev)], "batch": MULTI_BATCH,
          "rows_a_device": MULTI_BATCH // 2, "utterances": len(two),
          "bit_equal_to_one_device_at_half_batch": bit_equal, "rerun_bit_equal": rerun_equal,
          "min_cos_vs_one_device_whole_batch": cos_whole,
          "max_abs_vs_one_device_whole_batch": max(float(np.abs(two[u] - whole[u]).max())
                                                   for u in whole),
          "legs": {k: {kk: vv for kk, vv in v.items() if kk != "vectors"}
                   for k, v in legs.items()},
          "refused": refused, "card": smi})
    return legs["two_replicas"]["counts"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from voxsrc2020_speaker_verification_tpu_torch import kernels, set_float32_precision
    from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()})

    emit({"phase": "build", "seconds": kernels.build_all(),
          "libraries": [os.path.basename(k.library_path()) for k in kernels.KERNELS]})

    set_float32_precision()  # the CLIs' precision rule: float32 stays float32
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = RES2NET_CONFIGS[MODEL]
    k2, k3, k10, head = forward_shapes(cfg)
    tcfg = RES2NET_CONFIGS[TRAIN_MODEL]
    k5, train_head = train_shapes(tcfg, TRAIN_BATCH, TRAIN_FRAMES, FEAT_DIM)
    chains = train_chains(tcfg, TRAIN_BATCH, TRAIN_FRAMES, FEAT_DIM)
    stride2 = train_stride2(tcfg, TRAIN_BATCH, TRAIN_FRAMES, FEAT_DIM)
    with torch.inference_mode():
        rows = [check_fbank(dev, gen), check_split(dev, gen, k2, cfg.split),
                check_bn_act(dev, gen, k3), check_stats_pool(dev, gen, head, train_head),
                check_split_stride2(dev, gen, {MODEL: (cfg.split, k10), TRAIN_MODEL: (
                    tcfg.split, forward_shapes(tcfg)[2])})]
        cmvn_row = check_sliding_cmvn(dev)
    split_per_forward = split_launches_by_function(k2, cfg.split)
    per_forward = {"split_conv": split_launches(k2, cfg.split),
                   "bn_act": sum(k3.values()), "stats_pool": 1,
                   "split_stride2": sum(k10.values())}

    train_rows = [check_stats_pool_bwd(dev, gen, train_head),
                  check_bn_train(dev, gen, k5, TRAIN_GROUPS),
                  check_margin_ce(dev, gen, 2, 5994), *check_split_train(dev, gen, chains,
                                                                         TRAIN_GROUPS),
                  *check_split_stride2_train(dev, gen, stride2, TRAIN_GROUPS)]
    # K1's general path, K5's spanning and K6's class-sharded modes
    slice12_rows = [check_fbank_general(dev), check_bn_span(dev, gen),
                    check_margin_partial(dev, gen)]
    torch.cuda.empty_cache()
    att_rows = list(check_att_pool(dev, gen))
    any_c, fold_rows = check_bn_any_c(dev, gen)
    k4_w1 = check_stats_pool_w1(dev, gen)
    head_row = check_bn_head(dev, gen)
    torch.cuda.empty_cache()
    # K5's one-launch cluster design takes the 4-D calls, its one-launch
    # head design the 2-D head calls (bn_train_plan): 8 + 8 head launches a
    # bench step, none of the multi-kernel design
    per_microbatch = {**k5_launches(k5, TRAIN_GROUPS), **K6_SLAB_PER_MICROBATCH,
                      **k9_launches(chains), **k11_launches(stride2),
                      **POOL_RING_PER_MICROBATCH}
    head_step = {k: TRAIN_ACCUM * per_microbatch[k] for k in K5_LAUNCH_KEYS
                 if "bn_head" in k or "bn_train_" in k}
    if (sum(v for k, v in head_step.items() if "bn_head_fwd" in k) != 8
            or sum(v for k, v in head_step.items() if "bn_head_bwd" in k) != 8
            or head_step["bn_train.bn_train_fwd"] or head_step["bn_train.bn_train_bwd"]):
        fail(f"K5 on the bench step's head calls: {head_step}, not 8 + 8 head launches")

    with tempfile.TemporaryDirectory() as workdir:
        counts, serve_fn_counts = serve_phase(dev, workdir, per_forward, split_per_forward)
        gc.collect()
        torch.cuda.empty_cache()
        state, train_cfg, train_counts = train_phase(dev, per_microbatch, smi)
        train_parity_phase(dev)
        k1_dither, raw_counts, k7_raw = raw_phase(dev, per_microbatch, smi, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        lmft_counts, lmft_per_microbatch, lmft_exp = lmft_phase(dev, state, smi, workdir)
        export_phase(dev, state, train_cfg, workdir)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        eval_counts = evaluate_phase(dev, lmft_exp, workdir, smi, cmvn_row)
        gc.collect()
        torch.cuda.empty_cache()
        enc_train, enc_extract = encoders_phase(dev, workdir, smi)
        gc.collect()
        torch.cuda.empty_cache()
        single_chip_phase(dev, workdir, smi)
        gc.collect()
        torch.cuda.empty_cache()
        launch_runs = launch_phase(dev, workdir, smi)
        trace_phase(dev, train_cfg, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        prep_dir, prep_seconds, prep_counts = prepare_phase(dev, workdir, smi)
        imported, import_counts = import_phase(dev, workdir, smi, prep_dir, prep_seconds)
        gc.collect()
        torch.cuda.empty_cache()
        multi_counts = multi_device_phase(dev, workdir, smi, imported, prep_dir, prep_seconds)
    for row in rows:
        row["launches"] = counts[row["name"]]
        if row["name"] in per_forward:
            row["launches_per_forward"] = per_forward[row["name"]]
        if row["name"] == "split_conv":
            row["launches_by_function"] = {k: v for k, v in serve_fn_counts.items()
                                           if k.startswith("split_conv.")}
            row["launches_per_forward_by_function"] = split_per_forward
        if row["name"] == "split_stride2":
            row["launches_by_function"] = {k: serve_fn_counts[k] for k in K10_FNS}
            row["launches_encoders_extract"] = {m: fn_total(c, "split_stride2.split_stride2")
                                                for m, c in enc_extract.items()}
    for row in train_rows:
        fns = row_counts(row, train_counts)
        row["launches"] = sum(fns.values())
        row["launches_by_function"] = fns
        row["launches_per_step"] = {k: TRAIN_ACCUM * per_microbatch.get(k, 0) for k in fns}
        row["launches_lmft"] = row_counts(row, lmft_counts)
        row["launches_per_step_lmft"] = {k: TRAIN_ACCUM * lmft_per_microbatch.get(k, 0)
                                         for k in fns}
        for path, info in row.get("paths", {}).items():
            info["launches_on_main_path"] = {
                phase: sum(v for k, v in c.items() if k.startswith("margin_ce.") and
                           k.endswith(f":{path}"))
                for phase, c in (("train", train_counts), ("lmft", lmft_counts))}
    # K7's main path: cli.extract --cmvn device over the evaluate phase's test set
    cmvn_row["launches"] = eval_counts["sliding_cmvn"]
    cmvn_row["launches_on"] = "evaluate phase, cli.extract --cmvn device over the test set"
    # and the raw phase's train step, A launches a step at its shape
    cmvn_row["launches_raw"] = raw_counts["sliding_cmvn.sliding_cmvn"]
    cmvn_row["by_shape"][f"{TRAIN_BATCH}x{k7_raw['frames']}"] = k7_raw
    for row in train_rows:
        row["launches_raw"] = row_counts(row, raw_counts)
    # the encoders phase: K8 / K8b on the attentive families' training and
    # extraction; K3 / K5 (their single-channel paths at dpn68's stem) too
    for row in att_rows:
        fn = "att_pool.att_pool_fwd" if row["name"] == "att_pool" else "att_pool.att_pool_bwd"
        row["launches"] = sum(c[fn] for c in enc_train.values()) + sum(
            c[fn] for c in enc_extract.values())
        row["launches_on"] = "encoders phase: training and extraction"
        row["launches_by_model"] = {m: {"train": enc_train[m][fn], "extract": enc_extract[m][fn]}
                                    for m in enc_train}
    # K4 / K4b's column design: the W = 1 heads of the encoders phase (TDNN
    # and ECAPA-512, training and extraction)
    for row in k4_w1:
        fn = ("stats_pool.stats_pool:column" if row["name"] == "stats_pool:column"
              else "stats_pool_bwd.stats_pool_bwd:column")
        row["launches"] = sum(c[fn] for c in enc_train.values()) + sum(
            c[fn] for c in enc_extract.values())
        row["launches_on"] = "encoders phase: training and extraction"
        row["launches_by_model"] = {m: {"train": enc_train[m][fn], "extract": enc_extract[m][fn]}
                                    for m in enc_train}
        if row["launches"] == 0:
            fail(f"the encoders phase launched no {row['name']}")
    # K3 and K5 by design: the serve / train phases and the encoders phase
    # (extraction for K3, training for K5); the folded designs' rows count
    # the encoders phase's launches (dpn68's 10-channel calls), which must
    # be some
    for row in rows + train_rows:
        if row["name"] in ("bn_act", "bn_train"):
            row["any_channel_count"] = any_c
            counts_by = enc_extract if row["name"] == "bn_act" else enc_train
            row["launches_encoders"] = {m: {k: v for k, v in c.items()
                                            if k.split(".")[0] == row["name"] and v}
                                        for m, c in counts_by.items()}
            main_counts = serve_fn_counts if row["name"] == "bn_act" else train_counts
            row["launches_by_design"] = {
                phase: {k.split(".", 1)[1]: v for k, v in c.items()
                        if k.split(".")[0] == row["name"] and "span" not in k}
                for phase, c in (("serve" if row["name"] == "bn_act" else "train", main_counts),
                                 *((f"encoders_{m}", cm) for m, cm in counts_by.items()))}
    # the head design's row: the train phase's launches (the bench step's
    # head calls), and those of the raw, lmft and encoders phases
    head_row["launches_by_function"] = {k: train_counts[k] for k in HEAD_BN_KEYS}
    head_row["launches"] = sum(head_row["launches_by_function"].values())
    head_row["launches_on"] = "train phase: the bench step's pre_bn and post_bn"
    head_row["launches_per_step"] = {k: TRAIN_ACCUM * per_microbatch[k] for k in HEAD_BN_KEYS}
    head_row["launches_raw"] = {k: raw_counts[k] for k in HEAD_BN_KEYS}
    head_row["launches_lmft"] = {k: lmft_counts[k] for k in HEAD_BN_KEYS}
    head_row["launches_encoders"] = {m: {k: c[k] for k in HEAD_BN_KEYS}
                                     for m, c in enc_train.items()}
    if head_row["launches"] == 0:
        fail("the train phase launched no bn_train:head")
    for row in fold_rows:
        fns = (("bn_act.bn_act:fold",) if row["name"] == "bn_act:fold"
               else ("bn_train.bn_cluster_fwd:fold", "bn_train.bn_cluster_bwd:fold"))
        counts_by = enc_extract if row["name"] == "bn_act:fold" else enc_train
        row["launches_by_model"] = {m: sum(c[fn] for fn in fns) for m, c in counts_by.items()}
        row["launches"] = sum(row["launches_by_model"].values())
        row["launches_on"] = ("encoders phase: extraction" if row["name"] == "bn_act:fold"
                              else "encoders phase: training")
        if row["launches_by_model"].get("dpn68", 0) == 0:
            fail(f"the encoders phase's dpn68 launched no {row['name']}")
    # the launch phase's ranks: K5's spanning and K6's partial launches (each
    # rank's, of its one step)
    span_row, partial_row = slice12_rows[1], slice12_rows[2]
    span_row["launches_by_rank"] = launch_runs["data2"]["launches_by_rank"]
    partial_row["launches_by_rank"] = launch_runs["model2"]["launches_by_rank"]
    for row, run in ((span_row, "data2"), (partial_row, "model2")):
        row["launches"] = sum(sum(r.values()) for r in launch_runs[run]["launches_by_rank"])
        row["launches_on"] = f"launch phase, cli.launch --num-processes 2 ({run}), one step"
    # slice 13's paths: prepare_data stages 4 and 5 (K1), the imported
    # model's extraction (K7, K2-K4) and the two-replica extraction
    slice13 = {"prepare_stage4": prep_counts[4], "prepare_stage5": prep_counts[5],
               "import_extract": import_counts, "multi_device_extract": multi_counts}
    for row in rows + [cmvn_row]:
        row["launches_slice13"] = {leg: c[row["name"]] for leg, c in slice13.items()}
        if not any(row["launches_slice13"].values()):
            fail(f"slice 13's paths launched no {row['name']}")
    emit({"kernels": rows + [k1_dither] + train_rows + [cmvn_row] + att_rows + slice12_rows
          + k4_w1 + fold_rows + [head_row]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
