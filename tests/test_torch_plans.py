"""PyTorch port: the launch plans of K2 (``models/res2net.py:split_plan``)
and K5 (``ops/nn.py:bn_train_plan``), checked on the CPU for every call
shape that ``chip_smoke.py``'s serving forward (``forward_shapes``, at each
serving bucket) and training step (``train_shapes``) give the kernels, and
K7's (``ops/cmvn.py:sliding_cmvn_plan``) at every extraction bucket with the
tile extent rule that the kernel computes on the card. The kernels
themselves run only on the card (tests/test_torch_kernels.py)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.models import RES2NET_CONFIGS  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn  # noqa: E402
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as tops  # noqa: E402

SMEM = 232448  # the most shared memory one block can take on the H100
# every Res2Net the package registers (a fixed list: tests register thin
# variants in the same dict while the suite is collected)
RES2NETS = ("res2net50_w24_s4_c64", "res2net50_w24_s4_c32", "res2net50_w8_s6_c16",
            "res2net101_w24_s4_c32_att", "res2net152_w24_s4_c32_att",
            "res2net200_w24_s4_c32_att")


def k2_calls(model, frames, monkeypatch):
    monkeypatch.setattr(chip_smoke, "FRAMES", frames)
    return chip_smoke.forward_shapes(RES2NET_CONFIGS[model])[0]


@pytest.mark.parametrize("model", RES2NETS)
@pytest.mark.parametrize("frames", [256, 512, 1000])
def test_split_plan_fits_every_serving_call(model, frames, monkeypatch):
    """Every stride-1 stage of the serving forward of every registered
    Res2Net gets a K2 plan: the fused chain where s * w <= 96 (its weights
    and two full-width patch stages with an (s-1)-position halo in one
    block's shared memory, 128 patch positions or 64), the pipelined variant
    at the other widths up to 48 (two CTAs' shared memory per SM, its patch
    rows within its m tiles), the warpgroup-MMA variant at w = 64, 96 and 192
    (its weight ring and two patch stages within 227 KB, the patch within
    its 256 or 128 rows, as many as fit); F cut into even tiles of at most
    16."""
    calls = k2_calls(model, frames, monkeypatch)
    split = RES2NET_CONFIGS[model].split
    assert calls
    for (w, t, f) in calls:
        plan = rn.split_plan(w, t, f, torch.bfloat16, split)
        if w * split <= 96:
            assert plan["variant"] == "fused", (w, t, f)
            tt, tf = plan["tt"], plan["tf"]
            assert plan["smem"] == rn._fused_smem(w, split - 1, tt, tf) <= SMEM
            assert tt * tf <= 128 and (tt * tf > 64 or tt == t)
        elif w <= 48:
            assert plan["variant"] == "pipe", (w, t, f)
            tt, tf, mt = plan["tt"], plan["tf"], plan["mt"]
            assert plan["smem"] == rn._pipe_smem(w, tt, tf) <= SMEM // 2 - 1024
            assert 64 * (mt - 1) < tt * tf <= 64 * mt and mt in (1, 2)
            assert (w // 8) in rn._PIPE_NT
        else:
            assert w in (64, 96, 192)
            assert plan["variant"] == "wgmma", (w, t, f)
            tt, tf = plan["tt"], plan["tf"]
            rows = rn._wgmma_rows(w)
            assert plan["smem"] == rn._wgmma_smem(w, tt, tf) <= SMEM
            assert rows == (256 if w <= 96 else 128)
            assert tt * tf <= rows and (tt == t or (tt + 1) * tf > rows
                                        or rn._wgmma_smem(w, tt + 1, tf) > SMEM)
        assert tf <= 16 and -(-f // tf) == -(-f // 16) and 1 <= tt <= t


def test_split_plan_ragged_stage4_and_other_variants():
    """The ragged stage-4 grid (T = 125, F = 10) at every width, per group
    and fused; float32 and widths off the 8-grid take the CUDA-core
    variant; the staged rows' strides are odd in 16-byte units."""
    for w in (8, 16, 24, 32, 48):
        plan = rn.split_plan(w, 125, 10, torch.bfloat16)
        assert plan["variant"] == "pipe" and plan["smem"] <= SMEM // 2 and plan["tf"] == 10
    for w, split in ((8, 4), (16, 4), (24, 4), (8, 6), (16, 6)):
        plan = rn.split_plan(w, 125, 10, torch.bfloat16, split)
        assert plan["variant"] == "fused" and plan["smem"] <= SMEM and plan["tf"] == 10
    for w in (64, 96, 192):
        assert rn.split_plan(w, 125, 10, torch.bfloat16, 4)["variant"] == "wgmma"
    # the first tensor-core variant keeps the other multiples of 8
    for w in (40, 56, 200, 264):
        assert rn.split_plan(w, 125, 10, torch.bfloat16, 4)["variant"] == "mma"
    assert rn.split_plan(24, 125, 10, torch.float32, 4)["variant"] == "fma"
    assert rn.split_plan(12, 125, 10, torch.bfloat16, 4)["variant"] == "fma"
    # conflict-free ldmatrix rows: odd strides in 16-byte units
    for w in (8, 16, 24, 32, 48, 64, 96, 192):
        assert (rn._halo_stride(w) // 8) % 2 == 1 and rn._halo_stride(w) >= w
    for c in (32, 48, 64, 96, 128, 192):
        assert (rn._chain_stride(c) // 8) % 2 == 1 and rn._chain_stride(c) >= c


def test_wgmma_plan_at_every_width_and_grid():
    """The warpgroup-MMA plan at every width it takes (multiples of 16 from
    64 to 192) on grids from one frame to the serving stages: within 227 KB,
    the patch within the variant's rows, tt as large as the rows and the
    shared memory allow; the weight slices cut K = 9w evenly into k steps of
    16 that never cross a tap; a plan whose shared memory cannot fit even one
    frame row falls back to the first tensor-core variant."""
    for w in range(64, 193, 16):
        rows = rn._wgmma_rows(w)
        kslice = 32 if rows == 256 else 48
        assert (9 * w) % kslice == 0 and w % 16 == 0
        for t, f in ((1, 10), (1, 1), (7, 13), (125, 10), (250, 20), (500, 40), (1000, 80),
                     (300, 16), (300, 17)):
            plan = rn.split_plan(w, t, f, torch.bfloat16, 4)
            if plan["variant"] == "pipe":
                continue
            assert plan["variant"] == "wgmma", (w, t, f)
            tt, tf = plan["tt"], plan["tf"]
            assert plan["smem"] == rn._wgmma_smem(w, tt, tf) <= SMEM
            assert 1 <= tt <= t and tt * tf <= rows
            assert tt == min(rows // tf, t) or rn._wgmma_smem(w, tt + 1, tf) > SMEM
    # the shared memory grows with the patch: two stages of (tt + 2)(tf + 2)
    # halo positions at the padded stride
    assert (rn._wgmma_smem(96, 11, 10) - rn._wgmma_smem(96, 10, 10)
            == 2 * 2 * 12 * rn._halo_stride(96))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [8, 1])
def test_bn_train_plan_every_training_call(dtype, groups):
    """Every K5 call of the bench training step (B = 256, in 8 BN groups or
    one), and the split groups' BN calls of the stride-1 chain's earlier
    route (F.conv2d + K5 a group, which chip_smoke.py times beside K9): the
    4-D calls take the one-launch cluster design with a valid geometry
    (threads = ct_v * rpb <= 512 covering the full row, rpb a power of two,
    ring chunks of whole row-lane rounds, four or more chunks in flight for
    the most tensors a pass streams, shared memory within one block), the
    2-D head calls the head design (``assert_head_geometry``: pre_bn on
    16-byte vector lanes, post_bn on single-channel lanes); a second call
    with the same signature gets the same (cached) plan."""
    cfg = RES2NET_CONFIGS["res2net50_w8_s6_c16"]
    k5, _ = chip_smoke.train_shapes(cfg, 256, 200, 80)
    k5 = list(k5) + [((b, w, t, f), True, 0) for ((b, _, t, f), w, _)
                     in chip_smoke.train_chains(cfg, 256, 200, 80)]
    vec = 16 // dtype.itemsize
    resident = 0
    for (shape, relu, mode) in k5:
        plan = tops.bn_train_plan(shape, groups, dtype, mode, relu)
        assert tops.bn_train_plan(torch.Size(shape), groups, dtype, mode, relu) is plan
        if len(shape) == 2:
            assert plan["design"] == "head", shape
            assert plan["lanes"] == ("vector" if shape[1] > 256 else "single"), shape
            assert_head_geometry(plan, shape, groups, dtype)
            continue
        assert plan["design"] == "cluster", shape
        c, row = shape[1], shape[1] * dtype.itemsize
        ct_v, rpb = plan["ct_v"], plan["rpb"]
        assert plan["threads"] == ct_v * rpb <= 512 and rpb & (rpb - 1) == 0
        assert ct_v * vec == c and 2 * ct_v * rpb > 512
        assert plan["rows"] == 256 // groups * shape[2] * shape[3]
        for d, streamed in (("fwd", 2 if mode else 1),
                            ("bwd", 2 + int(mode == 2 or (mode == 1 and relu)))):
            rr, ring = plan[f"{d}_ring_rows"], plan[f"{d}_ring_bytes"]
            # whole rounds of the row lanes, about four chunks in flight
            assert rr % rpb == 0 and plan[f"{d}_stages"] == ring // (streamed * rr * row)
            assert 4 <= plan[f"{d}_stages"] <= 16 and (rr == rpb or plan[f"{d}_stages"] < 8)
            assert plan[f"{d}_smem"] <= SMEM - 1024 and ring % 16 == 0
        # on the H100's 128 CTAs (one an SM, 128 // groups a group) a
        # forward slab that fits its ring is read from HBM once
        slab = -(-plan["rows"] // (128 // groups))
        resident += mode != 1 and slab <= plan["fwd_stages"] * plan["fwd_ring_rows"]
    # the stage-3 and stage-4 split groups (C = 32 at 50 x 20, 64 at 25 x 10)
    # in bf16, the stage-4 ones in float32
    assert resident >= (2 if dtype == torch.bfloat16 else 1)


def test_bn_train_plan_other_calls():
    """One BN group takes the cluster design too (the kernel spreads the
    group over the card); channels that do not fill 16-byte vectors take it
    on folded rows where a group's rows n are a multiple of the fewest rows
    that fill whole vectors (12 bf16 channels: 2 rows, n = 90; the fold 10
    of them gives 480 threads), else the multi-kernel design (10 channels:
    4 rows, 90 % 4 != 0) and rows wider than 512 vectors take the
    multi-kernel design; 2-D inputs take the head design."""
    plan = tops.bn_train_plan((256, 96, 200, 80), 1, torch.bfloat16, 0, False)
    assert plan["design"] == "cluster" and plan["rows"] == 256 * 200 * 80
    plan = tops.bn_train_plan((16, 12, 9, 5), 8, torch.bfloat16, 0, True)
    assert (plan["design"], plan["fold"], plan["ct_v"], plan["rows"]) == ("cluster", 10, 15, 90)
    assert tops.bn_train_plan((16, 10, 9, 5), 8, torch.bfloat16, 0, True)["design"] == "multi"
    assert tops.bn_train_plan((16, 10, 9, 5), 1, torch.bfloat16, 0, True)["fold"] == 12
    # dpn68's stem: 100 rows of 10 bf16 channels, 125 vectors x 4 row lanes
    plan = tops.bn_train_plan((256, 10, 200, 80), 8, torch.bfloat16, 0, True)
    assert (plan["fold"], plan["ct_v"], plan["rpb"], plan["threads"]) == (100, 125, 4, 500)
    assert tops.bn_train_plan((16, 12, 9, 5), 8, torch.float32, 0, True)["design"] == "cluster"
    assert tops.bn_train_plan((4, 4096, 3, 3), 1, torch.bfloat16, 0, True)["design"] == "cluster"
    assert tops.bn_train_plan((4, 4096, 3, 3), 1, torch.float32, 0, True)["design"] == "multi"
    assert tops.bn_train_plan((256, 10240), 8, torch.bfloat16, 0, False)["design"] == "head"


# K7: every extraction bucket (a batch of 8), one frame, lengths around the
# window (299-301) and around the tile size, and a 60,000-frame utterance
K7_LENGTHS = [(8, t) for t in chip_smoke.CMVN_BUCKETS] + [
    (8, 1), (8, 299), (8, 300), (8, 301), (8, 255), (8, 257), (40, 511), (40, 513),
    (1, 60000)]


def k7_valid_counts(t, tt, w):
    """n in {0, 1, w - 1, w, w + 1, every tile edge +- 1, T}, within [0, T]."""
    edges = {e + d for e in range(tt, t + 1, tt) for d in (-1, 0, 1)}
    return sorted(n for n in {0, 1, w - 1, w, w + 1, t} | edges if 0 <= n <= t)


@pytest.mark.parametrize("b,t", K7_LENGTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("norm_vars", [False, True])
def test_sliding_cmvn_plan_covers_every_window(b, t, center, norm_vars):
    """K7's plan at every extraction shape: for every valid count n, every
    frame's window (``window_bounds``, the plain version's rule) lies inside
    the extent that the kernel stages for its tile (``tile_extent``), and so
    does every valid frame; an extent holds at most TT + w rows and at most
    the plan's ``rows``; the shared memory fits one block."""
    w = 300
    plan = cmvn.sliding_cmvn_plan(b, t, 80, w, center, norm_vars, 100)
    tt = plan["tt"]
    assert plan["staged"] and plan["smem"] <= SMEM and plan["seg"] % 2 == 1
    assert plan["smem"] == cmvn._k7_smem(plan["rows"], plan["fb"], plan["seg"], True, norm_vars)
    assert plan["rows"] <= tt + w and plan["tiles"] * tt >= t > (plan["tiles"] - 1) * tt
    assert plan["groups"] * plan["fb"] >= 80 and plan["grid"] == b * plan["tiles"] * plan["groups"]
    ns = k7_valid_counts(t, tt, w)
    start, end = cmvn.window_bounds(t, torch.tensor(ns), w, center, 100)
    for i, n in enumerate(ns):
        for t0 in range(0, t, tt):
            t1 = min(t0 + tt, t)
            r0, r1 = cmvn.tile_extent(t0, t1, n, w, center, 100)
            assert 0 <= r0 <= r1 <= n and r1 - r0 <= plan["rows"], (n, t0, r0, r1)
            assert int(start[i, t0:t1].min()) >= r0 and int(end[i, t0:t1].max()) <= r1, (n, t0)
            if t0 < n:  # the tile's valid frames read x from the staged rows
                assert r0 <= t0 and min(t1, n) <= r1, (n, t0, r0, r1)


def test_sliding_cmvn_plan_past_n_and_long_windows():
    """A tile past n stages the last window, far to its left (an 8001-frame
    row of the 16,000 bucket: rows 7,701-8,000 for the tile at 15,360); the
    trailing rule's min_window above w widens the extent; a window whose
    extent does not fit shared memory takes the unstaged plan, its segment
    (odd) grown until the prefixes fit; a second call returns the cached plan."""
    plan = cmvn.sliding_cmvn_plan(8, 16000, 80, 300)
    assert (plan["tt"], plan["fb"], plan["grid"]) == (512, 8, 8 * 32 * 10)
    assert cmvn.sliding_cmvn_plan(8, 1000, 80, 300)["grid"] == 8 * 4 * 5  # tt 256, fb 16
    assert cmvn.tile_extent(15360, 16000, 8001, 300, True, 100) == (7701, 8001)
    assert cmvn.tile_extent(15360, 16000, 8001, 300, False, 100) == (7701, 8001)
    assert cmvn.sliding_cmvn_plan(8, 16000, 80, 300) is plan
    for mw in (450, 5000):
        p = cmvn.sliding_cmvn_plan(8, 2000, 80, 300, False, False, mw)
        assert p["rows"] == min(2000, p["tt"] - 1 + min(mw, 2000))
        for n in (0, 299, 449, 450, 1999, 2000):
            for t0 in range(0, 2000, p["tt"]):
                r0, r1 = cmvn.tile_extent(t0, min(t0 + p["tt"], 2000), n, 300, False, mw)
                assert r1 - r0 <= p["rows"]
    for w, norm_vars in ((6000, False), (40000, True)):
        p = cmvn.sliding_cmvn_plan(1, 60000, 80, w, True, norm_vars)
        assert not p["staged"] and p["seg"] % 2 == 1 and p["seg"] >= cmvn.K7_SEG
        assert p["smem"] == cmvn._k7_smem(p["rows"], p["fb"], p["seg"], False, norm_vars) <= SMEM
    # bins: groups of 8 or 16, fewer rounded up to a multiple of 4
    assert cmvn.sliding_cmvn_plan(2, 400, 30, 300)["groups"] == 2
    assert cmvn.sliding_cmvn_plan(2, 400, 5, 300)["fb"] == 8


# K5's spanning mode: (rows a batch row, batch rows a rank, ranks, groups,
# rank): one data rank's rows of a global batch whose BN groups span ranks
SPAN_LAYOUTS = [
    (200 * 80, 128, 2, 1, 0),     # chip_smoke's half of (256, 96, 200, 80), one group
    (200 * 80, 16, 16, 8, 5),     # a 256-row batch on 16 ranks, 8 groups: two ranks a group
    (45, 6, 2, 3, 0),             # groups of 4 rows over ranks of 6: a mid-group offset
    (45, 6, 2, 3, 1),             # and its second rank (touched 2, offset 270)
    (45, 4, 3, 2, 1),             # the middle rank of 3 meets both groups
    (1, 6, 2, 3, 1),              # a 2-D head input (per = 1)
    (1, 16, 2, 1, 1),             # a 2-D head's rank of 16 rows
    (25 * 10, 3, 5, 3, 2),        # 15 rows in 3 groups of 5 over 5 ranks of 3
]


@pytest.mark.parametrize("per,b,ranks,groups,rank", SPAN_LAYOUTS, ids=lambda v: str(v))
@pytest.mark.parametrize("channels,dtype", [(96, torch.bfloat16), (64, torch.float32),
                                            (24, torch.float32), (10, torch.bfloat16),
                                            (12, torch.bfloat16), (10240, torch.float32),
                                            (10240, torch.bfloat16), (40, torch.float32)])
def test_bn_span_plan_covers_each_row_once(per, b, ranks, groups, rank, channels, dtype):
    """K5's spanning plan (ops/nn.py:bn_span_plan) for a rank's rows: every
    (row, channel tile) is one CTA's, each CTA's rows lie inside one group
    (the group it names), the touched groups' CTAs are where their entries
    say (slab-major, tile-minor), one wave of CTAs on 132 SMs, the geometry
    covers the row's channels in tiles of at most 512 vectors of 16 bytes
    (or of single channels where the row does not fill them), and the ring
    (its chunks for 1-3 tensors, _SPAN_RING_STAGES of them) fits 227 KB."""
    lay = tops.SpanLayout(b * per, rank * b * per, b * ranks // groups * per, groups)
    plan = tops.bn_span_plan(lay, channels, dtype, 132)
    assert tops.bn_span_plan(lay, channels, dtype, 132) is plan
    vecn = 16 // dtype.itemsize
    ring = plan["design"] == "ring"
    assert ring == (channels % vecn == 0 and channels // vecn <= 512)
    assert plan["vec"] == (vecn if channels % vecn == 0 else 1)
    ct, rpb, tiles, vec = plan["ct"], plan["rpb"], plan["tiles"], plan["vec"]
    assert plan["threads"] == ct * rpb <= 512 and rpb & (rpb - 1) == 0 and 2 * ct * rpb > 512
    assert (tiles - 1) * ct * vec < channels <= tiles * ct * vec and plan["cw"] == ct * vec
    assert not ring or tiles == 1
    ctas, segs = plan["ctas"], plan["segs"]
    assert len(segs) == lay.touched
    per_sm = 1 if ring else tops._SPAN_DIRECT_CTAS_PER_SM
    assert len(ctas) <= 132 * per_sm + lay.touched * tiles
    for t in range(tiles):
        rows = sorted((lo, hi) for (_, lo, hi, tt) in ctas if tt == t)
        edges = [0] + [hi for _, hi in rows]
        assert [lo for lo, _ in rows] == edges[:-1] and edges[-1] == lay.nloc
        assert all(lo < hi for lo, hi in rows)
    for (g, lo, hi, _) in ctas:
        first = g * lay.ngroup - lay.offset
        assert first <= lo < hi <= first + lay.ngroup
    for z, (g, first, k) in enumerate(segs):
        assert g == lay.offset // lay.ngroup + z
        for j in range(k):
            for t in range(tiles):
                assert ctas[first + j * tiles + t][0] == g and ctas[first + j * tiles + t][3] == t
    assert sum(k for _, _, k in segs) * tiles == len(ctas)
    assert plan["smem"] <= SMEM - 1024 and plan["smem"] * per_sm <= 233472 - 1024 * per_sm
    if ring:
        row = channels * dtype.itemsize
        assert plan["smem"] == 4 * plan["threads"] * vec + plan["ring_bytes"]
        for ni, rr in zip((1, 2, 3), plan["ring_rows"]):
            stages = plan["ring_bytes"] // (ni * rr * row)
            assert rr % rpb == 0 and stages >= 2
            assert stages >= tops._SPAN_RING_STAGES or rr == rpb
            assert plan["ring_bytes"] % 16 == 0
    else:
        assert plan["smem"] == 4 * plan["threads"] * vec and plan["ring_bytes"] == 0


# K1's general path: the configs the fast design refuses (chip_smoke's two,
# a 32 ms frame, 600 mel bins at 32 kHz, 48 kHz)
GENERAL_CONFIGS = [dict(sample_rate=32000), dict(frame_length_ms=64.0),
                   dict(frame_length_ms=32.0), dict(sample_rate=32000, num_bins=600),
                   dict(sample_rate=48000)]


@pytest.mark.parametrize("kw", GENERAL_CONFIGS, ids=lambda kw: str(sorted(kw.items())))
@pytest.mark.parametrize("batch,frames", [(1, 798), (8, 398), (2, 1), (3, 12798)])
def test_fbank_general_plan_covers_every_frame_bin_and_weight(kw, batch, frames):
    """K1's general tile plan (ops/fbank.py:general_plan): its tiles cover
    every (frame, FFT bin) once, every packed mel weight is summed once (in
    exactly one tile's term, the terms of a column partition its run and lie
    in the tiles the last arrival adds), and the ring fits 227 KB."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as fb

    cfg = fb.FbankConfig(dither=0.0, **kw)
    assert fb.kernel_route(cfg) == "general"
    nfft = cfg.padded_frame_length // 2
    for dither in (False, True):
        plan = fb.general_plan(cfg, batch, frames, dither)
        tf, tb = plan["tile_frames"], plan["tile_bins"]
        assert plan["frame_tiles"] * tf >= frames > (plan["frame_tiles"] - 1) * tf
        assert plan["bin_tiles"] * tb >= nfft > (plan["bin_tiles"] - 1) * tb
        assert plan["ctas"] == plan["frame_tiles"] * plan["bin_tiles"] * batch
        assert plan["smem"] <= SMEM - 1024 and plan["threads"] == 256
        assert plan["part_floats"] == plan["bin_tiles"] * batch * frames * cfg.num_bins
        assert plan["tickets"] == batch * plan["frame_tiles"]
        # the epilogue's buffers (second half's sums, the power) fit the ring
        assert 4 * (64 * 128 + tf * (tb + 4)) <= plan["smem"]
    starts, offsets, weights = fb.mel_columns(fb.analysis_matrices(cfg)[2])
    counts = np.zeros(weights.size, np.int64)
    tiles_of = {}
    for t, c, lo, hi in fb.general_mel_terms(cfg):
        assert t * tb <= lo < hi <= min((t + 1) * tb, nfft)
        counts[offsets[c] + lo - starts[c]:offsets[c] + hi - starts[c]] += 1
        tiles_of.setdefault(c, []).append(t)
    assert (counts == 1).all()
    for c in range(cfg.num_bins):
        n = offsets[c + 1] - offsets[c]
        want = list(range(starts[c] // tb, (starts[c] + n - 1) // tb + 1)) if n else []
        assert tiles_of.get(c, []) == want, c


# K9 / K9b: every stride-1 chain of every registered Res2Net at its recipes'
# microbatch (pretraining at 200 frames, LMFT at 600, and the single-chip
# shapes), the thin test variants' widths, in both dtypes
def split_train_calls():
    from voxsrc2020_speaker_verification_tpu_torch.recipes import SINGLE_CHIP_SHAPES

    shapes = {(256, 200, 8), (128, 600, 8), (64, 600, 4)}
    shapes |= {(v["batch_size"], frames, v["bn_groups"])
               for (model, frames), v in SINGLE_CHIP_SHAPES.items() if model in RES2NETS}
    calls = set()
    for model in RES2NETS:
        for batch, frames, groups in shapes:
            for (shape, w, s) in chip_smoke.train_chains(RES2NET_CONFIGS[model], batch, frames, 80):
                calls.add((shape, w, s, groups))
    # the thin variants of the CPU tests (w = 4, 6, 8), chip_smoke's w24 stage
    # and a bf16 width of neither tensor-core variant (w = 40: fma)
    calls |= {((8, 24, 13, 21), 6, 4, 2), ((8, 24, 13, 21), 4, 6, 8), ((16, 32, 48, 40), 8, 4, 2),
              ((128, 96, 200, 80), 24, 4, 8), ((8, 160, 13, 21), 40, 4, 2)}
    return sorted(calls)


SPLIT_TRAIN_CALLS = split_train_calls()


@pytest.mark.parametrize("shape,width,split,groups", SPLIT_TRAIN_CALLS, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_train_plan_covers_every_position_once(shape, width, split, groups, dtype):
    """K9 / K9b's plan (models/res2net.py:split_train_plan) at every chain
    shape the registered configs reach: the variant (wgmma for bf16 at w =
    32, 48, 64, 96, 192; mma for bf16 at w = 8, 16, 24, its nt = w / 8 n
    tiles of 8 in one pass; else fma, as bf16 at w = 40), shared memory within 227 KB and equal to the
    layouts' (csrc/split_train.cu conv_smem, wgrad_smem; wg_conv_smem,
    wg_wgrad_layout), the patch within the variant's rows and the slabs a
    launch's CTAs; the weight tiles cover every (output channel, tap, input
    channel) once; a sample's slabs cover its patches (and, for the
    statistics launch, its positions) once, every slab inside one sample,
    and the patches every (t, f) once; the scratch sizes as the C entries
    count them, and the backward's folded statistics double-buffered."""
    b, c, t, f = shape
    plan = rn.split_train_plan(width, split, shape, groups, dtype)
    assert rn.split_train_plan(width, split, shape, groups, dtype) is plan
    wg = dtype == torch.bfloat16 and width in (32, 48, 64, 96, 192)
    mma = dtype == torch.bfloat16 and width in (8, 16, 24)
    assert plan["route"] == "kernels"
    assert plan["variant"] == ("wgmma" if wg else "mma" if mma else "fma")
    assert plan["nt"] == (width // 8 if mma else 0)
    tt, tf, ft = plan["tt"], plan["tf"], plan["ft"]
    hpos = (tt + 2) * (tf + 2)
    assert tf <= 16 and ft * tf >= f > (ft - 1) * tf and 1 <= tt <= t
    assert plan["smem_stats"] == 4 * 2 * (8 if wg or mma else 2) * 128
    cover = np.zeros((width, 9, width), np.int64)
    if wg:
        # the conv: 128 or 256 rows a patch (one or two 64-row m tiles a
        # consumer warpgroup, w / 2 accumulators each), T cut into even
        # tiles; the weight gradient: 64-row m tiles of (chunk q = 8-channel
        # group * 9 + tap, input channel) rows by all w output channels,
        # 3 wmt a tile, its chunks within nc8 8-channel groups (its halo)
        assert plan["mt"] * width // 2 <= 96 and tt * tf <= 128 * plan["mt"]
        assert tt == -(-t // -(-t // tt))  # the T tiles are even
        # the weights resident at w <= 64 (a slot a slice), else a ring
        slices = rn._train_wg_slices(width)
        assert plan["ring"] == slices if width <= 64 else 2 <= plan["ring"] < slices
        assert plan["smem_fwd"] == rn._train_wg_conv_smem(width, hpos, plan["ring"]) <= SMEM
        wtt = plan["wtt"]
        assert plan["ci_tile"] == wtt and wtt * tf <= 256 and wtt == -(-t // -(-t // wtt))
        assert plan["wpatches"] == -(-t // wtt) * ft
        assert plan["smem_grad"] == max(plan["smem_fwd"], rn._train_wg_wgrad_smem(
            width, wtt, tf)) <= SMEM
        wmt, nq = plan["wmt"], plan["nq"]
        assert nq == 9 * (width // 8) and wmt * width // 2 <= 96
        assert plan["went"] == 3 * wmt * 64 * width
        for wt in range(plan["wtiles"]):
            chunks = [q for q in range(24 * wmt * wt, 24 * wmt * (wt + 1)) if q < nq]
            assert chunks and chunks[-1] // 9 - chunks[0] // 9 < plan["nc8"]
            for q in chunks:
                cover[:, q % 9, 8 * (q // 9): 8 * (q // 9) + 8] += 1
    else:
        assert plan["smem_fwd"] == rn._train_conv_smem(width, tt, tf, mma) <= SMEM
        assert plan["smem_grad"] == max(plan["smem_fwd"], rn._train_wgrad_smem(
            width, tt, tf, mma)) <= SMEM
        assert tt * tf <= 128
        assert tt == min(128 // tf, t) or plan["smem_grad"] > SMEM // 2
    # weight tiles cover every (output channel, tap, input channel) once:
    # mma, m tiles of two (8-channel group, tap) chunks by all w output
    # channels, a tile's chunks within its halo's w / 8 8-channel groups;
    # float, 8 output by ci_tile input channels, every tap
    if mma:
        assert plan["nq"] == 9 * (width // 8) and plan["wm"] <= 8
        assert plan["went"] == plan["wm"] * 16 * width
        for wt in range(plan["wtiles"]):
            mts = range(wt * plan["wm"], min((wt + 1) * plan["wm"], plan["mtiles"]))
            chunks = [q for m in mts for q in (2 * m, 2 * m + 1) if q < plan["nq"]]
            assert chunks and chunks[-1] // 9 < width // 8
            for q in chunks:
                cover[:, q % 9, 8 * (q // 9): 8 * (q // 9) + 8] += 1
    elif not wg:
        co_t, ci_t = plan["co_tiles"], plan["ci_tiles"]
        assert plan["wtiles"] == co_t * ci_t and 9 * plan["ci_tile"] <= 5 * 128
        assert plan["went"] == 9 * plan["ci_tile"] * plan["co_tile"]
        for wt in range(plan["wtiles"]):
            co0, ci0 = (wt // ci_t) * plan["co_tile"], (wt % ci_t) * plan["ci_tile"]
            cover[co0:co0 + plan["co_tile"], :, ci0:ci0 + plan["ci_tile"]] += 1
    assert (cover == 1).all()
    assert plan["patches"] == -(-t // tt) * ft and 1 <= plan["k"] <= plan["patches"]
    assert plan["slabs"] == b * plan["k"]
    # slabs: sample-major, k a sample, each inside its sample
    for slab in range(plan["slabs"]):
        sample, lo, hi = rn.split_train_slab(plan, shape, slab)
        assert sample == slab // plan["k"] and 0 <= lo < hi <= plan["patches"]
    for positions, n in ((False, plan["patches"]), (True, t * f)):
        got = [rn.split_train_slab(plan, shape, slab, positions)[1:]
               for slab in range(plan["k"])]
        assert got[0][0] == 0 and got[-1][1] == n
        assert all(a[1] == b2[0] for a, b2 in zip(got, got[1:]))
    cover = np.zeros((t, f), np.int64)
    for pi in range(plan["patches"]):
        t0, f0 = (pi // ft) * tt, (pi % ft) * tf
        cover[t0:t0 + tt, f0:f0 + tf] += 1
    assert (cover == 1).all()
    # scratch: the slabs' (2, w) partials, the weight tiles' split partials
    # (went floats each), one ticket and, a weight tile, one a run of 32
    # splits and one for the runs
    assert plan["part_floats"] == plan["slabs"] * 2 * width
    assert plan["wpart_floats"] == plan["wtiles"] * plan["nsplit"] * plan["went"]
    assert plan["nchunks"] == -(-plan["nsplit"] // 32)
    assert plan["tickets"] == 1 + plan["wtiles"] * (plan["nchunks"] + 1)
    assert 1 <= plan["nsplit"] <= b * plan["wpatches" if wg else "patches"]
    # the backward's folded statistics: d_i and its sums, two buffers each
    # (group i reads one while it writes group i-1's into the other)
    assert plan["dy_elems"] == 2 * b * t * f * width
    assert plan["stats_floats"] == 2 * 2 * groups * width


def test_split_train_plan_span_route_and_refusals():
    """Where BN groups span data ranks the plan names the "span" route and
    nothing else; a shape that is not s groups of w, a batch that does not
    split into the BN groups, and a width over 256 are refused."""
    assert rn.split_train_plan(8, 6, (32, 48, 200, 80), 1, torch.float32, span=True) == {
        "route": "span"}
    with pytest.raises(ValueError):
        rn.split_train_plan(8, 6, (32, 40, 200, 80), 1, torch.bfloat16)
    with pytest.raises(ValueError):
        rn.split_train_plan(8, 6, (30, 48, 200, 80), 8, torch.bfloat16)
    with pytest.raises(ValueError):
        rn.split_train_plan(264, 4, (2, 1056, 10, 10), 1, torch.bfloat16)


# K4 / K4b: (B, C, T, W) at the heads the port pools: the Res2Net ring
# shapes (serving 125 frames, training 25, W = 10), the W = 1 heads of TDNN
# (320) and ECAPA (200), extraction buckets up to 1000 frames (and 1024), a
# ragged and a narrow C, and columns past what fits on chip
POOL_PLAN_SHAPES = [
    (128, 1024, 125, 10), (256, 512, 25, 10), (4, 32, 128, 10), (1, 8, 1, 1),
    (1024, 1536, 320, 1), (256, 1536, 200, 1), (128, 1536, 1000, 1), (3, 1536, 129, 1),
    (2, 1536, 1024, 1), (2, 20, 1000, 1), (3, 24, 1000, 1), (2, 3, 500, 1), (2, 64, 1200, 3),
    (1, 1536, 2200, 1), (1, 1536, 3148, 1), (1, 1536, 3149, 1), (1, 1536, 60000, 1),
    (2, 300, 700, 4),
]


@pytest.mark.parametrize("b,c,t,w", POOL_PLAN_SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stats_pool_plan_covers_each_channel_once_on_chip(b, c, t, w, dtype):
    """K4 / K4b's plan (ops/nn.py:stats_pool_plan): the (b, f, channel tile)
    work items cover every channel of every (b, f) once and every time row
    once (row lane q of a CTA of 4 warps takes rows q, q + R, ...); T <= 128
    plans the ring exactly as before the column design (512-byte rows, the
    column in one slab, 3 slabs, cp.async: the Res2Net heads' launches
    unchanged); a longer column up to 1000 rows and more (3,148 at 32-byte
    rows), in both dtypes, lies on chip (x read once, its rows by tensor
    copies) in 2 slabs at the widest tile row of 128, 64 or 32 bytes that
    leaves room for two CTAs an SM (else one), and no wider than C's row
    needs; only columns past that stream; shared memory stays within 227
    KB less the 1 KB kept for the mbarriers."""
    size = dtype.itemsize
    plan = tops.stats_pool_plan(b, t, w, c, dtype)
    assert tops.stats_pool_plan(b, t, w, c, dtype) is plan
    rb, tc, tiles = plan["row_bytes"], plan["tile_channels"], plan["tiles"]
    assert tc == rb // size and (tiles - 1) * tc < c <= tiles * tc and plan["work"] == b * w * tiles
    lanes = rb // 16                     # lanes a tile row, each 16 bytes of channels
    row_lanes = 4 * 32 // lanes          # rows a CTA reads at once
    assert sorted(c0 + l * (16 // size) + j for c0 in range(0, tiles * tc, tc)
                  for l in range(lanes) for j in range(16 // size)) == list(range(tiles * tc))
    rows, column = plan["rows"], plan["design"] == "column"
    walked = rows if plan["design"] == "stream" else t  # rows a slab's passes read
    assert sorted(r for q in range(row_lanes) for r in range(q, walked, row_lanes)) == \
        list(range(walked))
    part = 4 * (16 // size + 1) * 32 * 4
    limit = SMEM - 1024  # the rest: the slabs' mbarriers
    pad = 128 if column else 0  # the column design's slabs start 128-byte aligned

    def smem(stages, n, width):
        return stages * (n * width + -(-n // 4) * 16) + part + pad

    assert plan["smem"] == smem(plan["stages"], rows, rb) <= limit
    if t <= 128:
        assert (plan["design"], rb, rows, plan["stages"], plan["x_reads"]) == \
            ("ring", 512, t, 3, 1)
        assert plan["smem"] == 3 * (t * 512 + -(-t // 4) * 16) + part
    elif column:
        # tensor copies of at most 256 rows, each a multiple of 4 (128-byte
        # aligned in the slab), as few as T allows, covering T
        boxes, box_rows = plan["boxes"], plan["box_rows"]
        assert boxes == -(-t // 256) and box_rows <= 256 and box_rows % 4 == 0
        assert rows == boxes * box_rows and t <= rows < t + 4 * boxes
        # 2 slabs at the widest tile row (no wider than C's row needs) that
        # leaves room for two CTAs an SM, else the widest that fits one
        assert plan["stages"] == 2 and plan["x_reads"] == 1
        wide = next((r for r in (32, 64, 128) if r >= c * size), 128)
        fit = [r for r in (128, 64, 32) if r <= wide and smem(2, rows, r) <= limit]
        two = [r for r in fit if 233472 // (smem(2, rows, r) + 1280) >= 2]
        assert rb == (two or fit)[0] and tops.pool_ctas_per_sm(plan["smem"]) >= (2 if two else 1)
    else:
        assert plan["design"] == "stream" and (rb, rows, plan["stages"]) == (128, 256, 2)
        n = -(-t // 256)
        padded = n * (-(-(-(-t // n)) // 4) * 4)
        assert 2 * (padded * 32 + -(-padded // 4) * 16) + part + 128 > limit
        assert plan["x_reads"] == 2 and plan["boxes"] == 0
    if w == 1 and t <= 1024:
        assert plan["x_reads"] == 1 and (t <= 128 or plan["design"] == "column")


def test_stats_pool_plan_w1_heads():
    """The main path's W = 1 plans, as the header of csrc/stats_pool.cuh
    gives them: TDNN's and ECAPA's 1536 bf16 channels at 128-byte rows
    (64-channel tiles, two and three CTAs an SM; two tensor copies of 160
    rows, one of 200), a 1000-frame bucket at 32-byte rows (four copies of
    252 rows, two CTAs an SM); in float32 the same widths hold 32-channel
    tiles."""
    tdnn = tops.stats_pool_plan(1024, 320, 1, 1536, torch.bfloat16)
    ecapa = tops.stats_pool_plan(256, 200, 1, 1536, torch.bfloat16)
    bucket = tops.stats_pool_plan(128, 1000, 1, 1536, torch.bfloat16)
    assert (tdnn["design"], tdnn["row_bytes"], tdnn["tiles"], tdnn["smem"]) == \
        ("column", 128, 24, 89216)
    assert (tdnn["boxes"], tdnn["box_rows"], tops.pool_ctas_per_sm(tdnn["smem"])) == (2, 160, 2)
    assert (ecapa["row_bytes"], ecapa["smem"], ecapa["boxes"]) == (128, 57536, 1)
    assert tops.pool_ctas_per_sm(ecapa["smem"]) == 3
    assert (bucket["design"], bucket["row_bytes"], bucket["smem"]) == ("column", 32, 77312)
    assert (bucket["boxes"], bucket["box_rows"], bucket["rows"]) == (4, 252, 1008)
    for shape, rb in (((1024, 320, 1, 1536), 128), ((256, 200, 1, 1536), 128),
                      ((128, 1000, 1, 1536), 32)):
        p32 = tops.stats_pool_plan(*shape, torch.float32)
        assert (p32["design"], p32["row_bytes"], p32["tiles"]) == ("column", rb, 1536 * 4 // rb)


# ---------------------------------------------------------------------------
# K3 / K5 on folded rows: dpn68's 10-channel calls
# ---------------------------------------------------------------------------

# the dpn68 recipes' training shapes (microbatch, frames, bins) and the
# extraction bucket's (128 rows of 1000 frames)
DPN_RECIPES = ("dpn_vox2_dev_aug", "dpn_finetune_vox2_dev", "dpn_voxsrc2020_vox2_dev_aug")


def dpn68_bn_calls(batch, frames, feat_dim):
    """Every BN call of a dpn68 training forward at (batch, frames, bins),
    as (shape, relu, shortcut mode): recorded from a full-width forward on
    the CPU at 8 frames, the time axis scaled to ``frames`` (the strided
    stages halve it with SAME padding: ceil)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import get_model

    calls, orig = [], tops.bn_train

    def record(x, *args, **kw):
        calls.append((tuple(x.shape), bool(kw.get("relu", False))))
        return orig(x, *args, **kw)

    torch.manual_seed(0)
    model = get_model("dpn68", feat_dim=feat_dim)
    tops.bn_train = record
    try:
        with torch.no_grad():
            model(torch.randn(2, 8, feat_dim), True)
    finally:
        tops.bn_train = orig
    out = []
    for shape, relu in calls:
        if len(shape) == 4:
            shape = (batch, shape[1], -(-shape[2] * frames // 8), shape[3])
        else:
            shape = (batch, shape[1])
        out.append((shape, relu))
    return out


def fold_threads(c, fold, vec):
    """A CTA's threads at super-rows of ``fold`` rows of C channels: ct_v
    vectors by the most row lanes (a power of two) within 512 threads."""
    ct_v = c * fold // vec
    return ct_v * 2 ** int(np.log2(512 // ct_v))


def assert_fold_geometry(plan, shape, dtype):
    """A cluster plan's folded geometry: super-rows of ``fold`` rows fill
    whole 16-byte vectors (ct_v of them); the fold is a multiple of the
    fewest rows that do, divides the rows of a group and gives the most
    threads of all such folds (the smallest of those); each group starts
    16-byte aligned; the other checks as for rows of C channels."""
    vec, c = 16 // dtype.itemsize, shape[1]
    fold, ct_v, rpb = plan["fold"], plan["ct_v"], plan["rpb"]
    k = int(vec // np.gcd(c, vec))
    assert fold % k == 0 and ct_v * vec == c * fold
    # rows that fill 16-byte vectors are not folded
    folds = [1] if k == 1 else [f for f in range(k, 512 * k + 1, k)
                                if c * f // vec <= 512 and plan["rows"] % f == 0]
    most = max(fold_threads(c, f, vec) for f in folds)
    assert plan["threads"] == most and fold == min(f for f in folds
                                                   if fold_threads(c, f, vec) == most)
    assert plan["rows"] % fold == 0 and plan["rows"] * c * dtype.itemsize % 16 == 0
    assert plan["threads"] == ct_v * rpb <= 512 and rpb & (rpb - 1) == 0 and 2 * ct_v * rpb > 512
    row = c * fold * dtype.itemsize
    # the kernel's shared arrays hold C channels (rounded up to 4): the
    # super-channel sums are folded inside the CTA
    fixed = 4 * (plan["threads"] * vec + (2 * 2 + 4) * (-(-c // 4) * 4))
    assert plan["fwd_smem"] == fixed + plan["fwd_ring_bytes"] <= SMEM - 1024
    for d in ("fwd", "bwd"):
        rr, ring = plan[f"{d}_ring_rows"], plan[f"{d}_ring_bytes"]
        assert rr % rpb == 0 and ring % 16 == 0 and 4 <= plan[f"{d}_stages"] <= 16
        assert plan[f"{d}_stages"] * rr * row <= ring


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [8, 1])
@pytest.mark.parametrize("recipe", DPN_RECIPES)
def test_bn_plans_every_dpn68_call(recipe, groups, dtype):
    """Every BN call of dpn68 under each of its three recipes (at the
    recipe's microbatch, frames and bins): K5 takes the cluster design, on
    folded rows with a valid geometry where C does not fill 16-byte vectors
    (the 10-channel stem, stage 1's first projection and conv_a: three calls
    a microbatch) unless n % fold != 0 (then the multi-kernel design), the
    2-D head calls the head design; K3 (extraction, eval) takes
    4-channel vectors where C % 4 == 0, else the fold where F % fold == 0,
    else single channels."""
    from voxsrc2020_speaker_verification_tpu_torch.recipes import get_recipe

    cfg, _ = get_recipe(recipe)
    calls = dpn68_bn_calls(cfg.batch_size, cfg.feat_length, cfg.feat_dim)
    vec = 16 // dtype.itemsize
    folded = 0
    for shape, relu in calls:
        plan = tops.bn_train_plan(shape, groups, dtype, 0, relu)
        if len(shape) == 2:
            assert plan["design"] == "head", shape
            assert plan["lanes"] == ("vector" if shape[1] > 256 else "single"), shape
            assert_head_geometry(plan, shape, groups, dtype)
            continue
        c = shape[1]
        fold = vec // np.gcd(c, vec)
        n = shape[0] // groups * shape[2] * shape[3]
        if n % fold:
            assert plan["design"] == "multi", shape
            continue
        assert plan["design"] == "cluster" and plan["rows"] == n, shape
        assert_fold_geometry(plan, shape, dtype)
        folded += plan["fold"] > 1
        k3 = tops.bn_act_plan(shape, dtype)
        if c % 4 == 0:
            assert k3 == {"design": "vec", "fold": 0}
        else:
            assert k3["design"] == ("fold" if shape[3] % fold == 0 else "single")
            assert k3["fold"] == (fold if k3["design"] == "fold" else 0)
    assert folded == 3 and sum(s[1] == 10 for s, _ in calls if len(s) == 4) == 3
    bucket = tops.bn_act_plan((128, 10, 1000, cfg.feat_dim), dtype)
    assert bucket == {"design": "fold", "fold": vec // np.gcd(10, vec)}


def test_bn_act_plan_paths():
    """K3's path by shape: the fold needs F % fold == 0 (F = 5 with 4 bf16
    rows: single channels) and at most 256 vectors a super-row."""
    assert tops.bn_act_plan((16, 10, 9, 5), torch.bfloat16) == {"design": "single", "fold": 0}
    assert tops.bn_act_plan((16, 10, 9, 4), torch.bfloat16) == {"design": "fold", "fold": 4}
    assert tops.bn_act_plan((16, 10, 9, 5), torch.float32) == {"design": "single", "fold": 0}
    assert tops.bn_act_plan((16, 12, 9, 5), torch.bfloat16) == {"design": "vec", "fold": 0}
    assert tops.bn_act_plan((4, 3, 9, 8), torch.bfloat16) == {"design": "fold", "fold": 8}
    # 1021 channels: 8 rows of 1021 bf16 values are 1021 vectors
    assert tops.bn_act_plan((4, 1021, 3, 8), torch.bfloat16)["design"] == "single"


def fold_lanes(plan_fold, channels, dtype):
    """The kernels' lane map of a super-row: element j of 16-byte vector
    lane is super-channel lane * vec + j, channel (lane * vec + j) % C."""
    vec = 16 // dtype.itemsize
    width = channels * plan_fold
    assert width % vec == 0
    return torch.arange(width) % channels


def integer_inputs(shape, seed, dtype):
    """Seeded inputs on a grid of 1/4 in [-4, 4): every float32 sum over a
    group is exact, so sums taken in any order agree bit for bit."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-16, 16, size=shape).astype(np.float32) / 4).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if x.ndim == 4 else x


def bn_train_folded(x, running_mean, running_var, groups, plan, relu):
    """K5's cluster design on folded rows, emulated on the CPU: x's
    channels-last rows viewed as (G, n / fold, C * fold) super-rows, each
    super-channel summed over the super-rows, the fold's super-channels of
    a channel added in order (s = c, c + C, ...), the statistics tiled back
    onto the super-row by the lane map and applied there. The statistics'
    arithmetic is the plain version's (mean = sum / n); the running
    statistics are updated in place."""
    b, c = x.shape[:2]
    fold = plan["fold"]
    sup = x.permute(0, 2, 3, 1).reshape(groups, plan["rows"] // fold, c * fold).float()
    chan = fold_lanes(fold, c, x.dtype)
    s1, s2 = sup.sum(1), torch.square(sup).sum(1)
    sums = [torch.zeros(groups, c), torch.zeros(groups, c)]
    for i in range(fold):  # the kernel's fold order
        sums[0] += s1[:, i * c:(i + 1) * c]
        sums[1] += s2[:, i * c:(i + 1) * c]
    n = plan["rows"]
    mean = sums[0] / n
    var = sums[1] / n - torch.square(mean)
    _, upd_mean, upd_var = tops._update_factors(x, groups)
    running_mean.copy_(tops.BN_MOMENTUM * running_mean + upd_mean * mean.mean(0))
    running_var.copy_(tops.BN_MOMENTUM * running_var + upd_var * var.mean(0))
    y = ((sup - mean[:, None, chan]) * torch.rsqrt(var[:, None, chan] + tops.BN_EPSILON)).to(x.dtype)
    if relu:
        y = torch.relu(y)
    return y.reshape(b, x.shape[2], x.shape[3], c).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def bn_act_folded(x, mean, var, mask, fold):
    """K3's folded path with relu and a time mask, emulated on the CPU:
    super-rows of ``fold`` positions, each lane's statistics by the lane
    map, and one mask row a super-row, super-row q / (F / fold)."""
    b, c, t, f = x.shape
    sup = x.permute(0, 2, 3, 1).reshape(-1, c * fold)
    chan = fold_lanes(fold, c, x.dtype)
    y = ((sup.float() - mean[chan]) * torch.rsqrt(var[chan] + tops.BN_EPSILON)).to(x.dtype)
    y = torch.relu(y)
    q = torch.arange(sup.shape[0])
    y = y * mask.reshape(-1)[q // (f // fold)].to(x.dtype)[:, None]
    return y.reshape(b, t, f, c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


# thin shapes whose rows fold: dpn68's 10 channels and 3 and 1
FOLD_SHAPES = [((16, 10, 12, 8), 8), ((16, 10, 12, 8), 1), ((8, 3, 10, 8), 2), ((8, 1, 6, 8), 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", FOLD_SHAPES, ids=str)
def test_fold_index_math_matches_plain_versions(shape, groups, dtype):
    """The folded view with its tiled statistics gives bn_train_reference's
    output and running statistics, and bn_act_reference's output (relu and
    a time mask), bit for bit, on the plans' folds."""
    plan = tops.bn_train_plan(shape, groups, dtype, 0, True)
    assert plan["design"] == "cluster" and plan["fold"] > 1
    c = shape[1]
    x = integer_inputs(shape, 1, dtype)
    rng = np.random.RandomState(2)
    rm, rv = torch.from_numpy(rng.randn(c).astype(np.float32)), torch.from_numpy(
        rng.uniform(0.5, 2.0, c).astype(np.float32))
    want_stats, got_stats = [rm.clone(), rv.clone()], [rm.clone(), rv.clone()]
    want = tops.bn_train_reference(x, *want_stats, groups=groups, relu=True)
    got = bn_train_folded(x, *got_stats, groups, plan, relu=True)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_stats, want_stats))

    k3 = tops.bn_act_plan(shape, dtype)
    assert k3["design"] == "fold"
    mask = torch.from_numpy((np.arange(shape[2])[None] < rng.randint(
        1, shape[2] + 1, shape[0])[:, None]).astype(np.float32))
    want = tops.bn_act_reference(x, rm, rv, relu=True, mask=mask)
    assert torch.equal(bn_act_folded(x, rm, rv, mask, k3["fold"]), want)


# ---------------------------------------------------------------------------
# K5's head design (the 2-D calls)
# ---------------------------------------------------------------------------

HEAD_THREADS, HEAD_ROWS = 256, 8  # a CTA's threads at most; rows a thread keeps at once


def assert_head_geometry(plan, shape, groups, dtype):
    """The head design's tiling of a (B, C) call: the channel tiles cover
    every channel once (ctas * cl lanes of v channels, the last tile ragged
    by less than one tile), the row lanes' slabs cover all B rows, each
    slab inside one group (slab divides n), every group the same number of
    row lanes; the CTA within 256 threads, its tree's shared memory (4
    sums of v channels a thread forward, 3 backward) within the 48 KB of
    static launch, and the rows a thread keeps at once (8) in registers
    (at most 3 operands x 8 rows x 4 registers a 16-byte vector); and the
    geometry the plan's rules give: the largest slab up to 8 rows that
    fits; on vector lanes a tile of at most 128 threads where its CTAs
    number 132 to 396, else the widest that keeps 256 threads and 132 CTAs;
    on single lanes the widest up to 32 within 256 threads."""
    b, c = shape
    n = b // groups
    vec = 16 // dtype.itemsize
    v, cl, rl, slab = plan["v"], plan["cl"], plan["rl"], plan["slab"]
    assert v == (vec if plan["lanes"] == "vector" else 1) and c % v == 0
    assert plan["lanes"] == "single" or c // vec >= 132
    lanes = c // v
    assert plan["ctas"] * cl >= lanes > (plan["ctas"] - 1) * cl
    assert cl & (cl - 1) == 0 and cl <= (8 if v > 1 else 32)
    assert rl * slab == b and n % slab == 0 and rl % groups == 0
    assert plan["threads"] == cl * rl <= HEAD_THREADS
    assert plan["rounds"] == -(-slab // HEAD_ROWS)
    assert plan["fwd_smem"] == 4 * 4 * v * cl * rl <= 48 * 1024
    assert plan["bwd_smem"] == 4 * 3 * v * cl * rl <= plan["fwd_smem"]
    assert plan["bwd_tile_regs"] == 3 * min(slab, HEAD_ROWS) * (4 if v > 1 else 1) <= 96
    slab0 = max(d for d in range(1, HEAD_ROWS + 1) if n % d == 0)
    if v == 1:
        assert slab == slab0 or b // HEAD_ROWS > 256
        assert cl == 32 or cl * 2 * rl > HEAD_THREADS
        return

    def ctas(w):
        return -(-lanes // w)
    rl0 = b // slab0
    small = [w for w in (8, 4, 2) if w * rl0 <= HEAD_THREADS // 2 and 132 <= ctas(w) <= 396]
    if small:
        want = small[0]
    else:
        want = max([w for w in (8, 4, 2, 1) if w * rl0 <= HEAD_THREADS and ctas(w) >= 132]
                   or [1])
    assert cl == want or b // HEAD_ROWS > 256
    # thinner slabs only while the call gives fewer than 256 threads an SM:
    # the next larger slab gave fewer, and this one gives as many or has no
    # thinner slab within 256 threads
    if slab < slab0:
        prev = min(d for d in range(slab + 1, slab0 + 1) if n % d == 0)
        assert plan["ctas"] * cl * (b // prev) < 132 * HEAD_THREADS
    if b // HEAD_ROWS <= 256:
        assert plan["ctas"] * plan["threads"] >= 132 * HEAD_THREADS or not any(
            n % d == 0 and cl * (b // d) <= HEAD_THREADS for d in range(1, slab))


def head_calls():
    """Every 2-D K5 call of the training recipes (EmbeddingHead's pre_bn and
    post_bn, ECAPA's), as (model, B, C, groups): the bench step's
    res2net50_w8_s6_c16 and res2net50_w24_s4_c32 from
    ``chip_smoke.train_shapes``, the --single-chip rows of
    ``recipes.SINGLE_CHIP_SHAPES`` at 200 frames, and each family's recipe
    (res2net50_w24_s4_c64, dpn68, TDNN, ECAPA-512) with its widths read off
    the model's head BNs on the meta device."""
    from voxsrc2020_speaker_verification_tpu_torch.models import get_model
    from voxsrc2020_speaker_verification_tpu_torch.recipes import SINGLE_CHIP_SHAPES, get_recipe

    calls = set()
    for model, b, g in (("res2net50_w8_s6_c16", 256, 8), ("res2net50_w24_s4_c32", 256, 8)):
        k5, _ = chip_smoke.train_shapes(RES2NET_CONFIGS[model], b, 200, 80)
        calls.update((model, s[0], s[1], g) for (s, _, _) in k5 if len(s) == 2)
    runs = [(get_recipe(r)[0], None) for r in ("res2net_vox2_dev_aug", "dpn_vox2_dev_aug",
                                                "tdnn_voxsrc2020_vox2_dev_aug",
                                                "ecapa_vox2_dev_aug")]
    runs += [(None, (m, kw)) for (m, t), kw in SINGLE_CHIP_SHAPES.items() if t == 200]
    for cfg, single in runs:
        model, feat_dim = (cfg.model, cfg.feat_dim) if cfg else (single[0], 80)
        b, g = (cfg.batch_size, cfg.bn_groups) if cfg else (single[1]["batch_size"],
                                                            single[1]["bn_groups"])
        with torch.device("meta"):
            net = get_model(model, feat_dim=feat_dim)
        for name, mod in net.named_modules():
            if name.endswith(("pre_bn", "post_bn")):
                calls.add((model, b, mod.running_mean.shape[0], g))
    return sorted(calls)


HEAD_CALLS = head_calls()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("model,b,c,groups", HEAD_CALLS, ids=str)
def test_bn_head_plan_every_head_call(model, b, c, groups, dtype):
    """Each head call takes the head design in one read (its slab in
    registers, 8 rows but at ECAPA's pre_bn, which thins them to fill the
    card) with a valid tiling: the pre_bn calls on 16-byte vector
    lanes, the post_bn calls (192 or 256 channels: fewer vectors than SMs)
    on single-channel lanes; the bench step's pre_bn at (256, 10240) bf16
    in 8 groups is 320 CTAs of 4 vectors x 32 row lanes, its post_bn 24 of
    8 channels x 32 row lanes; a misaligned tensor takes single-channel
    lanes of the same design, by the plan."""
    plan = tops.bn_train_plan((b, c), groups, dtype, 0, False)
    vector = c // (16 // dtype.itemsize) >= 132
    assert plan["design"] == "head" and plan["lanes"] == ("vector" if vector else "single")
    assert vector == (c > 256), (model, b, c)
    assert plan["rounds"] == 1 and (plan["slab"] == 8 or (b, c) == (256, 3072))
    assert_head_geometry(plan, (b, c), groups, dtype)
    if c == 3072 and b == 256:  # ECAPA's pre_bn: too small to fill the card on 8-row slabs
        assert plan["slab"] == (2 if dtype == torch.bfloat16 else 4)
    single = tops.bn_train_plan((b, c), groups, dtype, 0, False, False)
    assert single["lanes"] == "single" and single["v"] == 1
    assert_head_geometry(single, (b, c), groups, dtype)
    if (b, groups, dtype) == (256, 8, torch.bfloat16) and c in (10240, 192):
        want = (4, 32, 320, 128) if c == 10240 else (8, 32, 24, 256)
        assert (plan["cl"], plan["rl"], plan["ctas"], plan["threads"]) == want


def test_head_calls_cover_the_table():
    """The head calls the plan test holds: the bench's pre_bn / post_bn
    (post_bn at the bench model's output_dim, 192), --single-chip's (512,
    10240) in 16 groups, the north star's and the recipe default's, dpn68's,
    TDNN's at 1024 rows and ECAPA's."""
    calls = {(b, c, g) for (_, b, c, g) in HEAD_CALLS}
    assert {(256, 10240, 8), (256, 192, 8), (512, 10240, 16), (256, 20480, 8), (256, 256, 8),
            (256, 40960, 8), (128, 20480, 4), (256, 16640, 8), (1024, 3072, 8),
            (1024, 256, 8), (256, 3072, 1), (256, 192, 1)} <= calls


@pytest.mark.parametrize("shape,groups,dtype,lanes,slab", [
    ((64, 40), 8, torch.bfloat16, "single", 8), ((64, 41), 8, torch.bfloat16, "single", 8),
    ((64, 1048), 8, torch.bfloat16, "single", 8), ((64, 1048), 8, torch.float32, "vector", 1),
    ((40, 40960), 8, torch.float32, "vector", 5), ((4096, 2048), 1, torch.bfloat16, "vector", 16),
    ((3000, 7), 1, torch.float32, "single", 12), ((2048, 16), 256, torch.bfloat16, "single", 8)],
    ids=str)
def test_bn_head_plan_other_calls(shape, groups, dtype, lanes, slab):
    """C that does not fill 16-byte vectors, or whose vectors number fewer
    than the card's 132 SMs (1048 bf16 channels: 131 vectors; 1048 float32
    ones are 262), takes single-channel lanes; n without a divisor of 8 takes
    its largest divisor up to 8 (n = 5: slab 5), a call too small to give
    the card 256 threads an SM thinner slabs (64 float32 rows of 1048: one
    row a lane); a B whose slabs of 8 rows
    would need more than 256 row lanes reads its slab in rounds (4096 rows:
    slab 16, 2 rounds; 3000: 12); 256 groups fit and 512 do not."""
    plan = tops.bn_train_plan(shape, groups, dtype, 0, True)
    assert (plan["design"], plan["lanes"], plan["slab"]) == ("head", lanes, slab)
    assert_head_geometry(plan, shape, groups, dtype)
    with pytest.raises(tops.KernelError):
        tops.bn_head_plan(4096, 16, 512, dtype)


def bn_head_emulated(x, running_mean, running_var, groups, plan, dy=None):
    """K5's head design emulated on the CPU in float32, in the kernel's
    order of operations: each row lane's slab summed row by row, each
    group's row lanes added in the kernel's pairwise tree (lane i adds lane
    i + s where i % 2s == 0), mean = sum * (1 / n), var = sum(x^2) * (1 / n)
    - mean^2, the running update in group order (in place), y = (x - mean)
    * rstd; with ``dy``, dx from sum(dy) and sum(dy * xhat) the same way.
    Returns (y, dx)."""
    b, c = x.shape
    rl, slab, lanes = plan["rl"], plan["slab"], plan["rl"] // groups
    inv_n = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(b // groups))

    def group_sums(t):  # (B, C) -> (G, C): the slab in order, then the tree
        rows = t.reshape(rl, slab, c)
        part = torch.zeros(rl, c)
        for k in range(slab):
            part = part + rows[:, k]
        part = part.reshape(groups, lanes, c).clone()
        s = 1
        while s < lanes:
            for i in range(0, lanes - s, 2 * s):
                part[:, i] = part[:, i] + part[:, i + s]
            s *= 2
        return part[:, 0]

    xf = x.float()
    mean = group_sums(xf) * inv_n
    var = group_sums(xf * xf) * inv_n - mean * mean
    rstd = torch.rsqrt(var + tops.BN_EPSILON)
    _, upd_mean, upd_var = tops._update_factors(x, groups)
    msum, vsum = torch.zeros(c), torch.zeros(c)
    for g in range(groups):
        msum, vsum = msum + mean[g], vsum + var[g]
    inv_g = torch.tensor(1.0) / groups
    running_mean.copy_(tops.BN_MOMENTUM * running_mean + upd_mean * (msum * inv_g))
    running_var.copy_(tops.BN_MOMENTUM * running_var + upd_var * (vsum * inv_g))
    g_of = torch.arange(b) // (b // groups)
    xhat = (xf - mean[g_of]) * rstd[g_of]
    y = xhat.to(x.dtype)
    if dy is None:
        return y, None
    d = dy.float()
    ca, cb = group_sums(d) * inv_n, group_sums(d * xhat) * inv_n
    dx = rstd[g_of] * (d - ca[g_of] - xhat * cb[g_of])
    return y, dx.to(x.dtype)


@pytest.mark.parametrize("shape,groups", [((64, 40), 8), ((64, 40), 1), ((48, 24), 3),
                                          ((40, 12), 8), ((4096, 8), 1), ((256, 24), 8),
                                          ((64, 1056), 2)],
                         ids=str)
@pytest.mark.parametrize("aligned", [True, False])
def test_head_emulation_matches_plain_version(shape, groups, aligned):
    """The head design's order of sums, on its plan's tiling (vector lanes
    at (64, 1056) aligned, single-channel lanes elsewhere), gives the plain
    version's output, running statistics and gradient (bn_train_reference,
    its autograd) on inputs whose sums are exact: to float32 rounding of
    1 / n against division by n (1e-6)."""
    plan = tops.bn_train_plan(shape, groups, torch.float32, 0, False, aligned)
    assert plan["lanes"] == ("vector" if aligned and shape[1] == 1056 else "single")
    x = integer_inputs(shape, 1, torch.float32)
    dy = integer_inputs(shape, 2, torch.float32)
    rng = np.random.RandomState(3)
    c = shape[1]
    rm = torch.from_numpy(rng.randn(c).astype(np.float32))
    rv = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
    st = [rm.clone(), rv.clone()]
    y, dx = bn_head_emulated(x, st[0], st[1], groups, plan, dy)
    xi = x.clone().requires_grad_(True)
    ref = [rm.clone(), rv.clone()]
    yr = tops.bn_train_reference(xi, ref[0], ref[1], groups=groups)
    yr.backward(dy)
    for a, b in ((y, yr.detach()), (dx, xi.grad), (st[0], ref[0]), (st[1], ref[1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# K10 (csrc/split_stride2.cu), the stride-2 split stage in eval: its plan at
# every stride-2 stage of the registered Res2Nets, at the serving buckets
# (B = 128) and the training shape (200 frames, B = 256), and at the thin
# test variants' stage (w = 8, s = 4: widths (4, 8), strides (1, 2)) at the
# CPU tests' shapes and the serving bucket
def stride2_calls():
    calls = [("thin", 8, 4, (b, 32, t, f)) for b, t, f in ((2, 48, 40), (16, 200, 80),
                                                          (128, 1000, 80), (1, 9, 7))]
    for model in RES2NETS:
        cfg = RES2NET_CONFIGS[model]
        for frames, batch in ((200, 256), (256, 128), (512, 128), (1000, 128)):
            t, f = frames, 80
            for i in range(len(cfg.block_sizes)):
                if cfg.block_strides[i] == 2:
                    w = cfg.width[i]
                    calls.append((model, w, cfg.split, (batch, cfg.split * w, t, f)))
                    t, f = rn._strided(t, 2), rn._strided(f, 2)
    return calls


STRIDE2_CALLS = stride2_calls()


@pytest.mark.parametrize("model,width,split,shape", STRIDE2_CALLS, ids=str)
def test_stride2_plan_fits_every_stride2_stage(model, width, split, shape):
    """The bf16 plan takes the mma design at every stride-2 stage, the thin
    w = 8 included: a kernel the C entry instantiates (the width's output
    slices and input chunks, whole k steps a chunk where the input is cut),
    at most 8 consumer warps of 32 rows and a producer warp, its shared
    memory (the slice's weights, two ring stages, the output rows, the
    mbarriers: the layout the kernel checks) within 227 KB and per_sm CTAs
    of it within an SM, F' cut into even tiles of at most 16, T' into even
    tiles, the tiles covering T' x F', and the CTAs one wave of the 132
    SMs."""
    b, _, t, f = shape
    tout, fout = rn._strided(t, 2), rn._strided(f, 2)
    plan = rn.stride2_plan(width, split, shape, torch.bfloat16)
    assert plan["design"] == "mma"
    assert plan == rn.stride2_candidates(width, split, shape)[0]
    nsl, nkc, wn, tt, tf = plan["nsl"], plan["nkc"], plan["wn"], plan["tt"], plan["tf"]
    mt, tma, wg, ds = plan["mt"], plan["tma"], plan["wg"], plan["ds"]
    assert (nsl, nkc, mt, tma, wg, ds) == rn._STRIDE2_RING[width]
    assert not nsl or (width // nkc in (8, 16, 32, 64) or not tma) and (
        nkc == 1 or width // nkc % 16 == 0)
    assert wn == rn._stride2_wn(width, nsl, wg) and plan["nt"] * 8 * wn == width // (nsl or 1)
    assert nsl or (split * width == 64 * nkc and tma and wg and ds)
    if wg:  # warpgroups of 64 mt rows by the whole slice, a wgmma width
        warps = 4 * -(-tt * tf // (64 * mt))
        assert warps <= 8 and width // (nsl or 1) % 16 == 0 and 32 <= width // (nsl or 1) <= 192
    else:
        warps = wn * -(-tt * tf // (16 * mt))
    assert warps <= 8 and plan["threads"] == 32 * (warps + 2 - tma) <= 320
    assert plan["smem"] == rn._stride2_smem(width, nsl, nkc, tma, wg, ds, tt, tf) <= SMEM
    assert plan["per_sm"] * (plan["smem"] + 1024) <= 233472 and plan["per_sm"] in (1, 2)
    assert plan["per_sm"] == 1 or plan["threads"] <= 192
    assert 1 <= tt <= tout and tf <= 16 and -(-fout // tf) == -(-fout // 16)
    assert tt == -(-tout // -(-tout // tt))  # T' cut evenly
    assert plan["tiles"] == -(-tout // tt) * -(-fout // tf)
    assert plan["k"] <= b * plan["tiles"]
    assert ((split - 1) * nsl or 1) * plan["k"] <= 132 * plan["per_sm"]
    # the serving model's stages: the ring over the whole group's weights at
    # w = 48 and 96, a quarter of them at 192
    if model == "res2net50_w24_s4_c32" and t >= 250:
        assert nsl == {48: 0, 96: 1, 192: 4}[width]


def test_stride2_plan_other_designs():
    """float32 and the widths without an mma kernel take the FMA designs:
    16-byte vectors where w fills them (w % 4 in float32, % 8 in bf16), else
    single elements, nblk CTAs of 8 tn channels across a group; w = 48 has
    an mma kernel only at the whole-row form's s = 4, so other splits of 48
    take vec; a shape of another channel count is refused."""
    for w, dtype, design in ((48, torch.float32, "vec"), (5, torch.float32, "single"),
                             (6, torch.float32, "single"), (5, torch.bfloat16, "single"),
                             (12, torch.bfloat16, "single"), (56, torch.bfloat16, "vec"),
                             (24, torch.bfloat16, "vec"), (192, torch.float32, "vec")):
        plan = rn.stride2_plan(w, 4, (3, 4 * w, 17, 9), dtype)
        assert plan["design"] == design, (w, dtype)
        assert plan["smem"] == 0 and w <= 8 * plan["tn"] * plan["nblk"] < w + 8 * plan["tn"]
    assert rn.stride2_candidates(56, 4, (3, 224, 17, 9)) == []
    assert rn.stride2_candidates(48, 6, (3, 288, 17, 9)) == []
    assert rn.stride2_plan(48, 6, (3, 288, 17, 9), torch.bfloat16)["design"] == "vec"
    with pytest.raises(ValueError):
        rn.stride2_plan(48, 4, (3, 190, 17, 9), torch.bfloat16)
    with pytest.raises(ValueError):
        rn.Res2NetSplitConv(4, 8, 3)


def stride2_runs(plan, shape, split):
    """Each CTA of K10's mma design and its stages in order
    (csrc/split_stride2.cu: Run): CTA (group, slice, run j of k) takes the
    group's (sample, tile) items [items j / k, items (j + 1) / k), each
    nkc stages (its input chunks in order), and the pool stages [ps cta /
    nconv, ps (cta + 1) / nconv) of all ps = items nkc (item, chunk) pool
    stages, stage s a pool stage where floor((s + 1) sp / n) > floor(s sp /
    n). Returns [(grp, sl, [(pool, b, t0, f0, kc), ...]), ...]."""
    b, _, t, f = shape
    tout, fout = rn._strided(t, 2), rn._strided(f, 2)
    nsl, nkc, k, tt, tf = plan["nsl"], plan["nkc"], plan["k"], plan["tt"], plan["tf"]
    tiles_f = -(-fout // tf)
    items = b * plan["tiles"]
    if nsl == 0:  # the whole-row form: CTA j the items' nkc chunks in order
        out = []
        for j in range(k):
            stages = []
            for item in range(items * j // k, items * (j + 1) // k):
                bb, tile = divmod(item, plan["tiles"])
                tr, tc = divmod(tile, tiles_f)
                stages.extend((False, bb, tr * tt, tc * tf, c) for c in range(nkc))
            out.append((None, None, stages))
        return out
    nconv, ps = (split - 1) * nsl * k, items * nkc
    out = []
    for cta in range(nconv):
        grp, sl, j = cta // (nsl * k), cta // k % nsl, cta % k
        e0 = items * j // k
        sc = (items * (j + 1) // k - e0) * nkc
        q0 = ps * cta // nconv
        sp = ps * (cta + 1) // nconv - q0
        n = sc + sp
        stages = []
        for s in range(n):
            pb = s * sp // n
            pool = (s + 1) * sp // n > pb
            q = q0 + pb if pool else e0 * nkc + s - pb
            item, kc = divmod(q, nkc)
            bb, tile = divmod(item, plan["tiles"])
            tr, tc = divmod(tile, tiles_f)
            stages.append((pool, bb, tr * tt, tc * tf, kc))
        out.append((grp, sl, stages))
    return out


def emulate_stride2_mma(x, weight, split, plan):
    """K10's mma design replayed in float64, CTA by CTA: the slice's
    weights staged from OIHW as the kernel lays them out (tap-major K, each
    tap's w channels padded to tap_cols); each stage as its two TMA boxes
    land (the patch's even and odd input columns, rows of tf + 1 columns of
    a chunk of the input channels, zero outside the utterance, each byte at
    its swizzled offset) in ring slot s % 2 while the next stage lands in
    the other slot; A gathered at the kernel's swizzled byte offsets (row,
    tap and chunk; a tap's pad chunk re-reading the last real chunk); the
    accumulators carried across a tile's chunks and written at its last;
    the pool's nine taps out of the slot. Returns (the conv of groups < s-1
    before the BN, the pool of the last group), each output position
    written once."""
    if plan["nsl"] == 0:
        return emulate_stride2_rows(x, weight, split, plan)
    xs = x.double().numpy()
    wt = weight.double().numpy()
    b, c, t, f = xs.shape
    w = c // split
    nsl, nkc, tt, tf = plan["nsl"], plan["nkc"], plan["tt"], plan["tf"]
    wsl, cw = w // nsl, w // nkc
    kt = rn._stride2_tap_cols(w)
    ws = 9 * kt + 8
    ksc = -(-cw // 16)
    pt_n = 2 * tt + 1
    tma = plan["tma"]
    box = -(-rn._stride2_box(w, nkc, tma, tt, tf) // 1024) * 1024
    rs = rn._stride2_row_bytes(cw, tma)
    mask = {8: 0, 16: 0x10, 32: 0x30, 64: 0x70}[cw] if tma else 0
    tout, fout = rn._strided(t, 2), rn._strided(f, 2)

    def swz(off):
        return off ^ ((off >> 3) & mask)

    def toff(tap):  # bytes: the odd box at kf = 1, row kt, the next column at kf = 2
        kt_, kf = divmod(tap, 3)
        return (box if kf == 1 else 0) + (kt_ * (tf + 1) + (kf == 2)) * rs

    rows = np.arange(tt * tf)
    rowbase = (2 * (rows // tf) * (tf + 1) + rows % tf) * rs
    # the A byte offsets and B columns of a stage of chunk kc: k step (tap,
    # ks), lanes 0-15 the first 8 k, lanes 16-31 the next 8 (the pad chunk
    # at odd cw / 8)
    acols, bcols = [], []
    for tap in range(9):
        for ks in range(ksc):
            for h in (0, 1):
                cc = 16 * ks
                if (cw // 8) % 2 and cc + 8 * h >= cw:
                    cc -= 8
                acols.extend(toff(tap) + 16 * h + 2 * cc + 2 * e for e in range(8))
                bcols.extend(tap * kt + 16 * ks + 8 * h + e for e in range(8))
    acols, bcols = np.asarray(acols), np.asarray(bcols)

    def stage(bb, t0, f0, c0):
        buf = np.zeros(box)  # 2 box bytes as bf16 elements
        for p in (0, 1):
            for pt in range(pt_n):
                ti = 2 * t0 - 1 + pt
                for i in range(tf + 1):
                    fi = 2 * f0 - 1 + p + 2 * i
                    if 0 <= ti < t and 0 <= fi < f:
                        for ch in range(cw):
                            off = p * box + (pt * (tf + 1) + i) * rs + ch * 2
                            buf[swz(off) // 2] = xs[bb, c0 + ch, ti, fi]
        return buf

    conv = np.zeros((b, (split - 1) * w, tout, fout))
    pool = np.zeros((b, w, tout, fout))
    written = np.zeros((b, c, tout, fout), np.int64)
    for grp, sl, stages in stride2_runs(plan, x.shape, split):
        wsm = np.zeros((wsl, ws))
        for n in range(wsl):
            for idx in range(9 * w):  # OIHW: c * 9 + tap
                wsm[n, (idx % 9) * kt + idx // 9] = wt[grp * w + sl * wsl + n, idx // 9,
                                                        (idx % 9) // 3, idx % 3]
        ring = [None, None]

        def produce(s):
            pool_, bb, t0, f0, kc = stages[s]
            ring[s % 2] = stage(bb, t0, f0, ((split - 1) if pool_ else grp) * w + kc * cw)

        produce(0)
        acc = np.zeros((tt * tf, wsl))
        for s, (pool_, bb, t0, f0, kc) in enumerate(stages):
            if s + 1 < len(stages):
                produce(s + 1)  # the next stage lands in the other slot meanwhile
            buf = ring[s % 2]
            if pool_:
                for r in rows:
                    u, v = divmod(r, tf)
                    if t0 + u < tout and f0 + v < fout:
                        base = rowbase[r] + 2 * np.arange(cw)
                        taps = [buf[swz(base + toff(tap)) // 2] for tap in range(9)]
                        pool[bb, kc * cw:(kc + 1) * cw, t0 + u, f0 + v] = sum(taps) / 9
                        lo = (split - 1) * w + kc * cw
                        written[bb, lo:lo + cw, t0 + u, f0 + v] += 1
                continue
            acc += buf[swz(rowbase[:, None] + acols[None, :]) // 2] @ wsm[:, kc * cw + bcols].T
            if kc == nkc - 1:
                for r in rows:
                    u, v = divmod(r, tf)
                    if t0 + u < tout and f0 + v < fout:
                        lo = grp * w + sl * wsl
                        conv[bb, lo:lo + wsl, t0 + u, f0 + v] = acc[r]
                        written[bb, lo:lo + wsl, t0 + u, f0 + v] += 1
                acc[:] = 0
    assert (written == 1).all()
    return conv, pool


def emulate_stride2_rows(x, weight, split, plan):
    """K10's whole-row form replayed in float64 (csrc/split_stride2.cu:
    stride2_rows_kernel): each stage one tile's chunk of 64 of x's channels
    as its two TMA boxes land (128-byte rows, swizzled) in ring slot s % 2;
    a chunk's 16-channel k steps into their conv group's accumulators (that
    group's weights), its last group's channels pooled; each conv group's
    output written after the tile's last chunk. Returns (the conv of groups
    < s-1 before the BN, the pool of the last group), each output position
    written once."""
    xs = x.double().numpy()
    wt = weight.double().numpy()
    b, c, t, f = xs.shape
    w = c // split
    ng, nkc, tt, tf = split - 1, plan["nkc"], plan["tt"], plan["tf"]
    kt = rn._stride2_tap_cols(w)
    pt_n, rs = 2 * tt + 1, 128
    box = -(-pt_n * (tf + 1) * rs // 1024) * 1024
    tout, fout = rn._strided(t, 2), rn._strided(f, 2)

    def swz(off):
        return off ^ ((off >> 3) & 0x70)

    def toff(tap):
        kt_, kf = divmod(tap, 3)
        return (box if kf == 1 else 0) + (kt_ * (tf + 1) + (kf == 2)) * rs

    rows = np.arange(tt * tf)
    rowbase = (2 * (rows // tf) * (tf + 1) + rows % tf) * rs
    # every group's weights, K = tap kt + c
    wk = np.zeros((ng, w, 9 * kt))
    for g in range(ng):
        for idx in range(9 * w):
            wk[g, :, (idx % 9) * kt + idx // 9] = wt[g * w:(g + 1) * w, idx // 9, (idx % 9) // 3,
                                                       idx % 3]

    def stage(bb, t0, f0, c0):
        buf = np.zeros(box)  # 2 box bytes as bf16 elements
        for p in (0, 1):
            for pt in range(pt_n):
                ti = 2 * t0 - 1 + pt
                for i in range(tf + 1):
                    fi = 2 * f0 - 1 + p + 2 * i
                    if 0 <= ti < t and 0 <= fi < f:
                        for ch in range(min(64, c - c0)):
                            off = p * box + (pt * (tf + 1) + i) * rs + ch * 2
                            buf[swz(off) // 2] = xs[bb, c0 + ch, ti, fi]
        return buf

    conv = np.zeros((b, ng * w, tout, fout))
    pool = np.zeros((b, w, tout, fout))
    written = np.zeros((b, c, tout, fout), np.int64)
    for _, _, stages in stride2_runs(plan, x.shape, split):
        ring = [None, None]
        if stages:
            ring[0] = stage(*stages[0][1:4], 64 * stages[0][4])
        acc = np.zeros((ng, tt * tf, w))
        for s, (_, bb, t0, f0, ci) in enumerate(stages):
            if s + 1 < len(stages):
                nb, nt0, nf0, nci = stages[s + 1][1:]
                ring[(s + 1) % 2] = stage(nb, nt0, nf0, 64 * nci)
            buf = ring[s % 2]
            for j in range(4):
                ch = 64 * ci + 16 * j
                if ch >= ng * w:  # the last group's channels: their pool
                    for r in rows:
                        u, v = divmod(r, tf)
                        if t0 + u < tout and f0 + v < fout:
                            base = rowbase[r] + 32 * j + 2 * np.arange(16)
                            taps = [buf[swz(base + toff(tap)) // 2] for tap in range(9)]
                            lo = ch - ng * w
                            pool[bb, lo:lo + 16, t0 + u, f0 + v] = sum(taps) / 9
                            written[bb, ch:ch + 16, t0 + u, f0 + v] += 1
                    continue
                g = ch // w
                acols = np.asarray([toff(tap) + 32 * j + 2 * e for tap in range(9)
                                    for e in range(16)])
                bcols = np.asarray([tap * kt + ch % w + e for tap in range(9) for e in range(16)])
                acc[g] += buf[swz(rowbase[:, None] + acols[None, :]) // 2] @ wk[g][:, bcols].T
            if ci == nkc - 1:
                for r in rows:
                    u, v = divmod(r, tf)
                    if t0 + u < tout and f0 + v < fout:
                        for g in range(ng):
                            conv[bb, g * w:(g + 1) * w, t0 + u, f0 + v] = acc[g, r]
                            written[bb, g * w:(g + 1) * w, t0 + u, f0 + v] += 1
                acc[:] = 0
    assert (written == 1).all()
    return conv, pool


@pytest.mark.parametrize("width,split,shape", [
    (8, 4, (2, 32, 9, 7)), (8, 6, (1, 48, 12, 21)), (16, 6, (1, 96, 10, 31)),
    (48, 4, (1, 192, 21, 19)), (64, 6, (1, 384, 26, 20)), (96, 4, (1, 384, 25, 20)),
    (192, 4, (1, 768, 24, 19))], ids=str)
def test_stride2_mma_index_math_matches_plain_version(width, split, shape):
    """Every mma plan's indexing (stride2_candidates: the CTAs' runs and
    their pool stages, the ring's slots, the patch slots, the row, tap and
    chunk offsets, the input chunks and output slices, the tap pad at w =
    8, the weights staged from OIHW), replayed in float64, gives the plain
    version's strided grouped conv and average pool, each output written
    once."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(width)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    weight = torch.randn(width * (split - 1), width, 3, 3, generator=g, dtype=torch.float64)
    xp = tops.fixed_padding(x, 3)
    want_conv = F.conv2d(xp[:, :width * (split - 1)], weight, stride=2, groups=split - 1).numpy()
    want_pool = tops.avg_pool_3x3(xp[:, width * (split - 1):], 2).numpy()
    plans = rn.stride2_candidates(width, split, shape)
    kinds = {(p["nsl"], p["nkc"], p["mt"], p["tma"], p["wg"], p["ds"]) for p in plans}
    assert plans and kinds == {rn._STRIDE2_RING[width]}
    # the consumers' rows (mt, wg) move no index the replay reads: one plan
    # each tiling and staging
    tilings = {(p["nsl"], p["nkc"], p["tma"], p["tt"], p["k"]): p for p in plans}
    for plan in tilings.values():
        conv, pool = emulate_stride2_mma(x, weight, split, plan)
        np.testing.assert_allclose(conv, want_conv, rtol=1e-10, atol=1e-10, err_msg=str(plan))
        np.testing.assert_allclose(pool, want_pool, rtol=1e-10, atol=1e-10, err_msg=str(plan))


# a stage of each registered (width, split), and every third call
STRIDE2_KINDS = [next(c for c in STRIDE2_CALLS if c[1:3] == ws)
                 for ws in sorted({c[1:3] for c in STRIDE2_CALLS})]


@pytest.mark.parametrize("model,width,split,shape", STRIDE2_CALLS[::3] + STRIDE2_KINDS, ids=str)
def test_stride2_plan_depends_on_the_shape_alone(model, width, split, shape, monkeypatch):
    """K10's plan asks nothing of the card (every query of one raises here)
    and the same shape gives the same plan; its CTAs' runs cover every
    (sample, tile) item of each (group, slice) once, in order, and the pool
    stages once over all CTAs, each CTA's pool stages spread among its conv
    stages (never two in a row where it has more conv stages); in the
    whole-row form every item's chunks once, in order."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels

    def card(*args, **kwargs):
        raise AssertionError("the plan asked the card")

    for name in ("get_device_properties", "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, card)
    monkeypatch.setattr(kernels, "num_sms", card)
    before = rn.stride2_plan(width, split, shape, torch.bfloat16)
    rn.stride2_plan.cache_clear()
    plan = rn.stride2_plan(width, split, shape, torch.bfloat16)
    assert plan == before
    items = shape[0] * plan["tiles"]
    if plan["nsl"] == 0:
        got = [st[1:] for _, _, stages in stride2_runs(plan, shape, split) for st in stages]
        assert len(got) == items * plan["nkc"] == len(set(got)) and got == sorted(got)
        return
    conv, pools = {}, []
    for grp, sl, stages in stride2_runs(plan, shape, split):
        kinds = [st[0] for st in stages]
        if kinds.count(False) >= kinds.count(True):
            assert not any(a and b for a, b in zip(kinds, kinds[1:]))
        for pool, bb, t0, f0, kc in stages:
            (pools if pool else conv.setdefault((grp, sl), [])).append((bb, t0, f0, kc))
    tiles = sorted({(bb, t0, f0) for bb, t0, f0, _ in pools})
    assert len(tiles) == items and len(pools) == items * plan["nkc"] == len(set(pools))
    assert sorted(conv) == [(g, s) for g in range(split - 1) for s in range(plan["nsl"])]
    for stages in conv.values():
        assert stages == sorted(pools, key=lambda st: (st[0], st[1], st[2], st[3]))


# K11 / K11b (csrc/split_stride2_train.cu), the stride-2 split stage in
# training: its plan at every stride-2 stage of the registered Res2Nets'
# training shapes (200 and 600 frames, B = 256 and 128, bn_groups 8)
def stride2_train_calls():
    calls = []
    for model in RES2NETS:
        cfg = RES2NET_CONFIGS[model]
        for frames, batch in ((200, 256), (600, 256), (200, 128)):
            for (shape, w, s) in chip_smoke.train_stride2(cfg, batch, frames, 80):
                calls.append((model, w, s, shape))
    return calls


STRIDE2_TRAIN_CALLS = stride2_train_calls()


def stride2_train_fwd_runs(plan, shape, groups):
    """The forward's BN partials as the mma design fills them
    (csrc/split_stride2_train.cu: fwd_run, RunSums): CTA j of k walks the
    group's (sample, tile) items [items j / k, items (j + 1) / k) and keeps
    one partial per BN group its run touches. Returns, per partial (j, h),
    its items."""
    items = shape[0] * plan["tiles"]
    bpg = shape[0] // groups
    parts = {}
    for j in range(plan["k"]):
        for e in range(items * j // plan["k"], items * (j + 1) // plan["k"]):
            g0 = items * j // plan["k"] // plan["tiles"] // bpg
            parts.setdefault((j, e // plan["tiles"] // bpg - g0), []).append(e)
    return parts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("model,width,split,shape", STRIDE2_TRAIN_CALLS, ids=str)
def test_stride2_train_plan_fits_every_training_stage(model, width, split, shape, dtype):
    """The plan of every stride-2 stage in training: bf16 on the mma design
    (the forward a warp per 32 rows of a tile of at most 128 and per slice
    half where a slice has 32 channels or more, the width's
    output slices and input chunks; the grad launch's warps, its tile within
    the dgrad's rows, dW's m tiles within 96 (w <= 64) or 64 accumulator
    registers a thread or one a warp, every m tile in a chunk, the dgrad slices within the
    chunks), float32 on the FMA design (a thread at most 8 rows); F' cut
    into even tiles of at most 16 and the tiles covering T' x F'; both
    launches' shared memory as the layout computes it and within 227 KB;
    the mma forward's CTAs at least one a BN group and one wave (each run
    within two BN groups), the grad's one wave; the FMA slabs within the
    tiles a sample; the statistics slabs within the positions; scratch sized
    for every partial."""
    b, c, t, f = shape
    groups = 8
    tout, fout = rn._strided(t, 2), rn._strided(f, 2)
    plan = rn.stride2_train_plan(width, split, shape, groups, dtype)
    assert rn.stride2_train_plan(width, split, shape, groups, dtype) is plan
    tt, tf, gtt = plan["tt"], plan["tf"], plan["gtt"]
    assert tf <= 16 and -(-fout // tf) == -(-fout // 16) and tt <= tout and gtt <= tout
    assert plan["tiles"] == -(-tout // tt) * -(-fout // tf)
    assert plan["gtiles"] == -(-tout // gtt) * -(-fout // tf)
    itemsize = 2 if dtype == torch.bfloat16 else 4
    ng = split - 1
    if dtype == torch.bfloat16:
        assert plan["design"] == "mma"
        assert (plan["nsl"], plan["nkc"]) == rn._S2T_FWD_SLICES[width]
        assert plan["threads"] == 32 * rn._s2t_fwd_wn(width) * -(-tt * tf // 32) <= 256
        warps, nds, wnd = rn._S2T_GRAD_WARPS[width]
        assert plan["gthreads"] == 32 * warps and gtt * tf <= 32 * (warps // wnd)
        assert width // plan["nsl"] % 8 == 0 and width // plan["nkc"] % 8 == 0
        assert nds == plan["nds"] and (nds == 1 or width // nds == 16)
        mtiles, upt, nchunks = rn._s2t_mma_wgrad(width)
        assert (plan["upt"], plan["nchunks"]) == (upt, nchunks)
        assert upt * width // 2 <= (96 if width <= 64 else 64) or upt == 1
        assert nchunks * warps * upt >= mtiles > (nchunks - 1) * warps * upt
        assert nds <= nchunks and plan["pc"] == warps * upt * 16
        smem = rn._s2t_smem(width, tt, tf, "mma", 2, plan["threads"], gtt)
        per_fwd = rn._s2t_per_sm(plan["smem_fwd"], plan["threads"])
        per_grad = rn._s2t_per_sm(plan["smem_grad"], plan["gthreads"])
        assert groups <= plan["k"] <= b * plan["tiles"]
        stage = rn._s2t_patch_bytes(tt, tf, rn._halo_stride(width // plan["nkc"]), 2, True)
        assert 4 * (2 * plan["k"] + 2 * groups) <= 2 * stage
        assert plan["k"] == groups or ng * plan["nsl"] * plan["k"] <= rn.PLAN_SMS * per_fwd
        assert plan["nconv"] == ng * plan["nsl"] * plan["k"]
        assert ng * nchunks * plan["nsplit"] <= rn.PLAN_SMS * per_grad or plan["nsplit"] == 1
        assert plan["part_floats"] >= ng * plan["k"] * 2 * 2 * width
        assert all(h <= 1 for _, h in stride2_train_fwd_runs(plan, shape, groups))
    else:
        assert plan["design"] == "fma" and plan["threads"] == 128 and plan["tn"] == 4
        assert tt * tf <= min(128, (128 // (width // 4)) * 8) and gtt == tt
        assert plan["pg"] == plan["threads"] // plan["nb"] and plan["upt"] <= 8
        assert plan["pc"] * plan["nchunks"] >= 9 * width > plan["pc"] * (plan["nchunks"] - 1)
        assert 1 <= plan["k"] <= plan["tiles"] and plan["nconv"] == ng * b * plan["k"]
        smem = rn._s2t_smem(width, tt, tf, "fma", itemsize)
        assert plan["part_floats"] >= 2 * width * plan["nconv"]
    assert (plan["smem_fwd"], plan["smem_grad"]) == smem and max(smem) <= SMEM
    assert 1 <= plan["kstat"] <= tout * fout and plan["nstat"] == ng * b * plan["kstat"]
    assert 1 <= plan["nsplit"] <= b * plan["gtiles"]
    assert plan["wpart_floats"] == ng * plan["nchunks"] * plan["nsplit"] * plan["pc"] * width
    assert plan["part_floats"] >= 2 * width * plan["nstat"]
    assert plan["tickets"] == ng * plan["nchunks"]
    # the bench step's stages: the weights whole and resident, tiles of
    # 90-126 rows in the forward
    if model == "res2net50_w8_s6_c16" and dtype == torch.bfloat16:
        assert (plan["nsl"], plan["nkc"]) == (1, 1) and 90 <= tt * tf <= 128


def test_stride2_train_plan_other_shapes():
    """Widths without an mma kernel take the FMA design (4-channel vectors
    where w % 4 == 0, else single channels); a shape of another channel
    count, a batch not in whole BN groups, a width over 256 and one whose
    single-channel blocks exceed the threads are refused; the weight
    gradient's split count is a function of the shape alone (mma: the
    CTAs a wave of PLAN_SMS SMs holds; fma: about _S2T_WGRAD_CTAS)."""
    for w, dtype, tn in ((24, torch.bfloat16, 4), (5, torch.bfloat16, 1), (5, torch.float32, 1),
                         (12, torch.float32, 4), (192, torch.float32, 4)):
        plan = rn.stride2_train_plan(w, 4, (4, 4 * w, 17, 9), 2, dtype)
        assert (plan["design"], plan["tn"]) == ("fma", tn), (w, dtype)
    with pytest.raises(ValueError):
        rn.stride2_train_plan(48, 4, (4, 190, 17, 9), 2, torch.bfloat16)
    with pytest.raises(ValueError):
        rn.stride2_train_plan(48, 4, (6, 192, 17, 9), 4, torch.bfloat16)
    with pytest.raises(ValueError):
        rn.stride2_train_plan(260, 4, (4, 1040, 17, 9), 2, torch.float32)
    with pytest.raises(ValueError):
        rn.stride2_train_plan(129, 4, (4, 516, 17, 9), 2, torch.float32)
    a = rn.stride2_train_plan(32, 6, (256, 192, 100, 40), 8, torch.bfloat16)
    assert a["nsplit"] == rn.PLAN_SMS * rn._s2t_per_sm(a["smem_grad"], a["gthreads"]) // (
        5 * a["nchunks"])
    a = rn.stride2_train_plan(32, 6, (256, 192, 100, 40), 8, torch.float32)
    assert a["nsplit"] == -(-rn._S2T_WGRAD_CTAS // (5 * a["nchunks"]))


@pytest.mark.parametrize("shape,width,split", chip_smoke.STRIDE2_TRAIN_SHAPES, ids=str)
def test_stride2_train_partials_depend_on_the_shape_alone(shape, width, split, monkeypatch):
    """Which positions each BN partial and each dW partial holds is fixed by
    the plan, and the plan by the shape: it asks nothing of the card (every
    query of one raises here), and the same shape gives the same plan. The
    forward's partials (a CTA's run within one BN group) cover every
    (sample, tile) item of a group once, each inside one BN group; the grad
    launch's runs (a chunk's nsplit CTAs) cover every tile once, in
    order."""
    from voxsrc2020_speaker_verification_tpu_torch import kernels

    def card(*args, **kwargs):
        raise AssertionError("the plan asked the card")

    for name in ("get_device_properties", "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, card)
    monkeypatch.setattr(kernels, "num_sms", card)
    before = rn.stride2_train_plan(width, split, shape, 8, torch.bfloat16)
    rn.stride2_train_plan.cache_clear()
    plan = rn.stride2_train_plan(width, split, shape, 8, torch.bfloat16)
    assert plan == before
    b = shape[0]
    parts = stride2_train_fwd_runs(plan, shape, 8)
    covered = sorted(e for items in parts.values() for e in items)
    assert covered == list(range(b * plan["tiles"]))
    bpg = b // 8
    assert all(len({e // plan["tiles"] // bpg for e in items}) == 1 for items in parts.values())
    ntl = b * plan["gtiles"]
    runs = [range(ntl * j // plan["nsplit"], ntl * (j + 1) // plan["nsplit"])
            for j in range(plan["nsplit"])]
    assert [e for r in runs for e in r] == list(range(ntl)) and all(len(r) for r in runs)


def stride2_train_wgrad_rows(plan, w, chunk):
    """The (tap, channel) rows q = tap * w + c of weight-gradient chunk
    ``chunk``, in the order of its partial's rows: mma, the chunk's m tiles
    of (tap, 16 channels) (chunk, chunk + nchunks, ...), a channel past w
    or an m tile past 9 ceil(w / 16) marking a pad row (9 w); fma, the run
    of pc rows q."""
    if plan["design"] == "fma":
        return list(range(chunk * plan["pc"], (chunk + 1) * plan["pc"]))
    cb, rows = -(-w // 16), []
    for pl in range(plan["pc"]):
        mt = pl // 16 * plan["nchunks"] + chunk
        c = (mt % cb) * 16 + pl % 16
        rows.append(mt // cb * w + c if mt < 9 * cb and c < w else 9 * w)
    return rows


def stride2_train_dgrad_weights(weight, split, w, plan):
    """The dgrad weights as the kernel stages them from the OIHW weight
    (csrc/split_stride2_train.cu: load_dgrad_weights for mma, each dgrad
    slice's rows; stage_tap_weights for fma): [group][slot][n][c], n the
    conv's output channel, c its input channel."""
    wflat = weight.numpy().reshape(-1)
    kt = rn._stride2_tap_cols(w)
    tap_slot = {3 * a + b: i for i, (a, b) in enumerate(rn._S2T_DGRAD_TAPS)}
    out = np.zeros((split - 1, 9, w, w))
    if plan["design"] == "fma":  # ws[k][m] = weight[(grp w + k) w + m][tap(slot)]
        for grp in range(split - 1):
            for slot, (a, b) in enumerate(rn._S2T_DGRAD_TAPS):
                for k in range(w):
                    for m in range(w):
                        out[grp, slot, k, m] = wflat[((grp * w + k) * w + m) * 9 + 3 * a + b]
        return out
    dsw = w // plan["nds"]
    for grp in range(split - 1):
        for dsl in range(plan["nds"]):
            wsm = np.zeros((dsw, 9 * kt))
            for n in range(w):
                for idx in range(9 * dsw):  # 8 v + e over the row's vectors
                    wsm[idx // 9, tap_slot[idx % 9] * kt + n] = wflat[
                        ((grp * w + n) * w + dsl * dsw) * 9 + idx]
            for cl in range(dsw):
                for slot in range(9):
                    out[grp, slot, :, dsl * dsw + cl] = wsm[cl, slot * kt: slot * kt + w]
    return out


def emulate_stride2_train_backward(x, weight, dz, dout_tail, split, plan):
    """K11b's index math replayed in float64 (numpy), from one dz patch a
    tile: the grad launch's tiles (gtt x tf; the dz patch of (gtt + 1) x
    (tf + 1) output positions, zero outside T' x F'), each tile's dgrad
    (each parity class's rows and its tap slots' patch offsets, the dgrad
    weights as the kernel stages them from the OIHW weight, dx's slices on
    their chunks) and its weight gradient (a chunk's (tap, channel) rows
    over the x patch's slots, the group's tiles split into the plan's
    nsplit runs, the runs' partials added in run order), and the pool's
    backward (dout / 9 from the 1, 2 or 4 windows covering each input
    position). Returns (dx, dW)."""
    xs_ = x.numpy()
    b, c, t, f = xs_.shape
    w = c // split
    tt, tf = plan["gtt"], plan["tf"]
    tout, fout = rn._strided(t, 2), rn._strided(f, 2)
    pf_n = 2 * tf + 1
    wkd = stride2_train_dgrad_weights(weight, split, w, plan)
    dzs = dz.numpy()
    dx = np.zeros_like(xs_)
    dw = np.zeros((split - 1, w, w, 9))
    tiles_f = -(-fout // tf)
    ntiles = b * plan["gtiles"]
    nds = max(1, plan.get("nds", 1))
    for grp in range(split - 1):
        wparts = {chunk: [] for chunk in range(plan["nchunks"])}
        for sp in range(plan["nsplit"]):
            rows = {chunk: [q for q in stride2_train_wgrad_rows(plan, w, chunk) if q < 9 * w]
                    for chunk in range(plan["nchunks"])}
            part = {chunk: np.zeros((len(rows[chunk]), w)) for chunk in rows}
            for tile in range(ntiles * sp // plan["nsplit"], ntiles * (sp + 1) // plan["nsplit"]):
                bi = tile // plan["gtiles"]
                t0 = tile % plan["gtiles"] // tiles_f * tt
                f0 = tile % plan["gtiles"] % tiles_f * tf
                # the tile's one dz patch
                dp = np.zeros(((tt + 1) * (tf + 1), w))
                for du in range(tt + 1):
                    for dv in range(tf + 1):
                        if t0 + du < tout and f0 + dv < fout:
                            dp[du * (tf + 1) + dv] = dzs[bi, grp * w:(grp + 1) * w, t0 + du,
                                                         f0 + dv]
                # the dgrad, slice by slice of dx's channels
                for dsl in range(nds):
                    cs = slice(dsl * w // nds, (dsl + 1) * w // nds)
                    for cls, (s0, s1) in enumerate(((0, 1), (1, 3), (3, 5), (5, 9))):
                        pt, pf = divmod(cls, 2)
                        for u in range(tt):
                            for v in range(tf):
                                ti, fi = 2 * (t0 + u) + pt, 2 * (f0 + v) + pf
                                if ti >= t or fi >= f:
                                    continue
                                acc = np.zeros(w)[cs]
                                for slot in range(s0, s1):
                                    ktp, kfp = rn._S2T_DGRAD_TAPS[slot]
                                    row = (u + (ktp == 0)) * (tf + 1) + v + (kfp == 0)
                                    acc += dp[row] @ wkd[grp, slot][:, cs]
                                dx[bi, grp * w:(grp + 1) * w, ti, fi][cs] = acc
                # the weight gradient over the tile's x patch and dz patch
                xp = np.zeros(((2 * tt + 1) * pf_n, w))
                for pt in range(2 * tt + 1):
                    for pf in range(pf_n):
                        ti, fi = 2 * t0 - 1 + pt, 2 * f0 - 1 + pf
                        if 0 <= ti < t and 0 <= fi < f:
                            slot = tf + 1 + pf // 2 if pf % 2 else pf // 2
                            xp[pt * pf_n + slot] = xs_[bi, grp * w:(grp + 1) * w, ti, fi]
                for ot in range(tt):
                    for of in range(tf):
                        d = dp[ot * (tf + 1) + of]  # zero past T' x F'
                        for chunk, qs in rows.items():
                            for i, q in enumerate(qs):
                                tap, ch = divmod(q, w)
                                kf = tap % 3
                                pos = 2 * ot * pf_n + of + (tap // 3) * pf_n + (
                                    tf + 1 if kf == 1 else kf // 2)
                                part[chunk][i] += xp[pos, ch] * d
            for chunk in rows:
                wparts[chunk].append((rows[chunk], part[chunk]))
        for chunk, splits in wparts.items():
            total = sum(p for _, p in splits)  # the runs in order
            for i, q in enumerate(splits[0][0]):
                tap, ch = divmod(q, w)
                dw[grp, :, ch, tap] = total[i]
    # the pool's backward
    tail = dout_tail.numpy()
    for ti in range(t):
        for fi in range(f):
            for ot in range(ti // 2, min((ti + 1) // 2, tout - 1) + 1):
                for of in range(fi // 2, min((fi + 1) // 2, fout - 1) + 1):
                    dx[:, (split - 1) * w:, ti, fi] += tail[:, :, ot, of] / 9
    return dx, dw.reshape((split - 1) * w, w, 3, 3)


@pytest.mark.parametrize("width,split,shape,dtype", [
    (8, 4, (2, 32, 9, 7), torch.bfloat16), (16, 6, (1, 96, 12, 11), torch.bfloat16),
    (5, 4, (2, 20, 10, 9), torch.float32), (12, 4, (1, 48, 11, 10), torch.float32),
    (48, 4, (1, 192, 8, 7), torch.bfloat16), (96, 4, (1, 384, 7, 6), torch.bfloat16)],
    ids=str)
def test_stride2_train_backward_index_math_matches_autograd(width, split, shape, dtype):
    """K11b's parity decomposition of dx (four dense convs of 1, 2, 2 and 4
    taps over each tile's one dz patch), the dgrad weights staged from the
    OIHW weight, the weight gradient's chunk, slot and run index math over
    the same patch and the pool's gather, replayed in float64 with the plan
    of each design, give autograd's gradients of F.conv2d (stride 2, pad 1,
    groups s-1) and of avg_pool_3x3 on the padded input."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(width + shape[2])
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    weight = torch.randn(width * (split - 1), width, 3, 3, generator=g, dtype=torch.float64)
    b, c, t, f = shape
    tout, fout = rn._strided(t, 2), rn._strided(f, 2)
    dz = torch.randn(b, width * (split - 1), tout, fout, generator=g, dtype=torch.float64)
    dtail = torch.randn(b, width, tout, fout, generator=g, dtype=torch.float64)
    xl, wl = x.clone().requires_grad_(True), weight.clone().requires_grad_(True)
    xp = tops.fixed_padding(xl, 3)
    out = torch.cat([F.conv2d(xp[:, :width * (split - 1)], wl, stride=2, groups=split - 1),
                     tops.avg_pool_3x3(xp[:, width * (split - 1):], 2)], dim=1)
    want_dx, want_dw = torch.autograd.grad(out, [xl, wl], torch.cat([dz, dtail], dim=1))
    plan = rn.stride2_train_plan(width, split, shape, 1, dtype)
    assert plan["design"] == ("mma" if dtype == torch.bfloat16 else "fma")
    dx, dw = emulate_stride2_train_backward(x, weight, dz, dtail, split, plan)
    np.testing.assert_allclose(dx, want_dx.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dw, want_dw.numpy(), rtol=1e-10, atol=1e-10)
