"""Res2Net speaker embedding models, eval and training mode.

Same architecture, names and configs as the JAX package's
``models/res2net.py``: a 3x3 stem, Res2Net bottleneck-v1 blocks in four
stages with strides (1, 2, 2, 2), and a stats-pool embedding head.

The stride-1 split stage is K2 (``csrc/split_conv.cu``, wrapped by
:func:`split_chain`): one launch per group fuses the masked hierarchical add,
the 3x3 conv, eval BN and relu. The stride-2 split stage is K10
(``csrc/split_stride2.cu``, wrapped by :func:`split_stride2`): one launch
reads x once, with the padding implicit, and writes the s-1 groups' strided
conv, eval BN and relu and the last group's 3x3 average pool into the
concatenated output.

Training mode: the stride-1 chain is K9 / K9b (``csrc/split_train.cu``,
wrapped by :func:`split_chain_train`): s launches forward (one a group,
each staging in_i = x_i + mask * y_{i-1}, the conv, z_i saved and its BN
statistics; then one that normalizes the last group) and s backward (the
last group's statistics, then one a group that folds the previous group's
statistics in). Where BN groups span data ranks (K5's spanning mode) the chain
keeps the per-group ``F.conv2d`` -> K5 route (``"span"``). The stride-2
stage in training is K11 / K11b (``csrc/split_stride2_train.cu``, wrapped
by :func:`split_stride2_train`): two launches forward (the conv with z
saved and its BN statistics, and the average-pool tail; then the
normalization into the output) and two backward (the BN sums of d; then dz
with the transposed conv gathered by input parity, the pool's backward and
the weight gradient). K2 and K10 stay the eval path, since their BN uses
running statistics.

Rematerialization (``remat``, ``remat_stages``, ``remat_keep_blocks``,
``remat_policy``, the JAX package's options) checkpoints whole bottleneck
blocks in training: the block's activations are dropped after the forward
and recomputed in the backward (:func:`remat_block`). The recomputed
forward runs K5 again without its running-statistics update, so the
statistics are updated once, as in the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..kernels import (SPLIT_CONV, SPLIT_STRIDE2, SPLIT_STRIDE2_TRAIN, SPLIT_TRAIN, KernelError,
                       PLAN_SMS, check_cuda, dtype_code, num_sms, ptr, stream_scratch)
from ..ops import nn as ops
from ..parallel.sharding import active_mesh

CHANNELS_LAST = torch.channels_last
_SPLIT_TN = (12, 8, 6, 4, 3, 2, 1)  # output channels per thread in K2
_PIPE_NT = (1, 2, 3, 4, 6, 8, 12)   # K2 pipelined widths, w = 8 * nt
_FUSED_NT, _FUSED_GROUPS = (1, 2, 3, 4), (3, 5)  # K2 fused-chain widths and s - 1
_WGMMA_W = tuple(range(64, 193, 16))  # K2 warpgroup-MMA widths: N = w of one wgmma
_SMEM_BYTES = 232448                # the most shared memory one block can take
# the pipelined variant keeps two CTAs on an SM (a lone 4-warp CTA cannot
# hide its latencies): at most half an SM's shared memory each
_PIPE_SMEM_MAX = _SMEM_BYTES // 2 - 1024


# The shared-memory layouts below mirror csrc/split_conv.cu (halo_stride,
# weight_stride, chain_stride, pipe_smem, fused_smem, wgmma_rows, wgmma_smem) so that the plan can
# be chosen, and checked on the CPU, without the card; each launch passes
# the plan's size and the kernel refuses one that differs from its own.


def _halo_stride(width: int) -> int:
    """bf16 row stride of a staged position (csrc/split_conv.cu:halo_stride)."""
    return width + 2 * ((4 - (width // 2) % 8 + 8) % 8)


def _pipe_smem(width: int, tt: int, tf: int) -> int:
    """Shared memory of K2's pipelined variant (csrc/split_conv.cu:pipe_smem):
    the weights, three halo-patch stages, two mbarriers, the halo table."""
    wstride = -(-9 * width // 16) * 16 + 8
    hpos = (tt + 2) * (tf + 2)
    return 2 * (width * wstride + 3 * hpos * _halo_stride(width)) + 16 + 4 * hpos


def _weight_stride(width: int) -> int:
    """bf16 row stride of the staged weights (csrc/split_conv.cu:weight_stride)."""
    return -(-9 * width // 16) * 16 + 8


def _chain_stride(channels: int) -> int:
    """bf16 row stride of a staged full-width position (csrc/split_conv.cu:chain_stride)."""
    return channels + (8 if (channels // 8) % 2 == 0 else 0)


def _fused_smem(width: int, groups: int, tt: int, tf: int) -> int:
    """Shared memory of K2's fused-chain variant (csrc/split_conv.cu:fused_smem):
    the groups' weights, two full-width patch stages with a ``groups``-position
    halo, two mbarriers, the halo table, the groups' eval BN."""
    xpos = (tt + 2 * groups) * (tf + 2 * groups)
    return (2 * (groups * width * _weight_stride(width)
                 + 2 * xpos * _chain_stride((groups + 1) * width))
            + 16 + 4 * (xpos + xpos % 2) + 8 * groups * width)


def _wgmma_rows(width: int) -> int:
    """Patch rows of K2's warpgroup-MMA variant (csrc/split_conv.cu:wgmma_rows):
    two consumer warpgroups of two 64-row m tiles where w is a multiple of 32
    up to 96, of one above (N = w fills 96 accumulator registers)."""
    return 256 if width % 32 == 0 and width <= 96 else 128


def _wgmma_smem(width: int, tt: int, tf: int) -> int:
    """Shared memory of K2's warpgroup-MMA variant (csrc/split_conv.cu:wgmma_smem):
    the weight ring (12 slices of 32 K rows at 256 patch rows, 5 of 48 at
    128), two halo-patch stages, the group's eval BN, the mbarriers."""
    ring, kslice = (12, 32) if _wgmma_rows(width) == 256 else (5, 48)
    return (ring * kslice * width * 2 + 2 * 2 * (tt + 2) * (tf + 2) * _halo_stride(width)
            + 8 * width + 8 * (4 + 2 * ring))


def split_plan(width: int, tlen: int, flen: int, dtype: torch.dtype, split: int = 0) -> dict:
    """K2's launch plan for a split chain of ``split`` groups of width
    ``width`` on a (T, F) grid (``split`` 0: one group's plan).

    Patches are ``tt`` x ``tf`` positions, F cut evenly into tiles of at most
    16, about 128 positions (64 where 128 do not fit). ``"fused"`` (bf16,
    w = 8, 16, 24, 32 with s = 4 or 6, where the groups' weights and two
    full-width patch stages with an (s-1)-position halo fit one block's
    shared memory): the whole chain in one launch. ``"pipe"`` (bf16, w = 8 *
    nt, the group's weights resident in shared memory): one launch per
    group, ``mt`` 16-row m tiles per warp, in half an SM's shared memory.
    ``"wgmma"`` (bf16, w a multiple of 16 from 64 to 192, where the weights do
    not fit beside the pipelined variant's stages: the w = 64, 96 and 192
    stages): one launch per group on Hopper's warpgroup MMA, N = w, the
    weights streamed through a ring; ``tt`` x ``tf`` <= ``_wgmma_rows(w)``
    positions, ``tt`` cut where the patch stages would not fit. ``"mma"``
    (bf16 at the other widths of 8k) and ``"fma"`` (float32, other widths)
    are the earlier variants."""
    if dtype != torch.bfloat16 or width % 8:
        return {"variant": "fma"}
    nt = width // 8
    ft = -(-flen // 16)
    tf = -(-flen // ft)
    if nt in _FUSED_NT and split - 1 in _FUSED_GROUPS:
        for rows in (128, 64):
            tt = max(1, min(rows // tf, tlen))
            smem = _fused_smem(width, split - 1, tt, tf)
            if smem <= _SMEM_BYTES:
                return {"variant": "fused", "nt": nt, "tt": tt, "tf": tf, "smem": smem}
    if nt in _PIPE_NT:
        for rows in (128, 64):
            tt = max(1, min(rows // tf, tlen))
            smem = _pipe_smem(width, tt, tf)
            if smem <= _PIPE_SMEM_MAX:
                return {"variant": "pipe", "nt": nt, "mt": -(-tt * tf // 64), "tt": tt,
                        "tf": tf, "smem": smem}
    if width in _WGMMA_W:
        for tt in range(max(1, min(_wgmma_rows(width) // tf, tlen)), 0, -1):
            smem = _wgmma_smem(width, tt, tf)
            if smem <= _SMEM_BYTES:
                return {"variant": "wgmma", "tt": tt, "tf": tf, "smem": smem}
    return {"variant": "mma"}


def split_chain_reference(x, weight, means, variances, mask=None,
                          eps=ops.BN_EPSILON) -> torch.Tensor:
    """Plain version of :func:`split_chain`, step for step as the JAX
    package's stride-1 branch (models/res2net.py:82-107)."""
    s = len(means) + 1
    w = x.shape[1] // s
    groups = torch.split(x, w, dim=1)
    outputs = []
    for idx in range(s - 1):
        inp = groups[idx]
        if idx > 0:
            inp = inp + ops.mask_time(outputs[idx - 1], mask)
        y = F.conv2d(inp, weight[idx * w: (idx + 1) * w], padding=1)
        outputs.append(torch.relu(ops._normalize(y, means[idx], variances[idx], eps)))
    outputs.append(groups[s - 1])
    return torch.cat(outputs, dim=1).contiguous(memory_format=CHANNELS_LAST)


def split_chain(x: torch.Tensor, weight: torch.Tensor,
                means: Sequence[torch.Tensor], variances: Sequence[torch.Tensor],
                mask: Optional[torch.Tensor] = None,
                eps: float = ops.BN_EPSILON) -> torch.Tensor:
    """Stride-1 Res2Net split chain in eval mode, K2 on CUDA:

        y_i = relu(BN_i(conv3x3_same(x_i + mask * y_{i-1})))   i < s-1
        y_{s-1} = x_{s-1}

    x: (B, s*w, T, F) channels_last; weight: (w*(s-1), w, 3, 3) OIHW in x's
    dtype, group i owning output rows [i*w, (i+1)*w); means/variances: s-1
    float32 (w,) running statistics; mask: (B, T') 0/1 with T' >= T.
    The plan (:func:`split_plan`) runs the chain in one launch, or in one
    launch per group writing y_i into its channel slice of the output.
    """
    s = len(means) + 1
    b, c, t, f = x.shape
    w = c // s
    if c != s * w or weight.shape != (w * (s - 1), w, 3, 3):
        raise ValueError(f"split_chain: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} do not make {s} groups of 3x3")
    if x.device.type == "cpu":
        return split_chain_reference(x, weight, means, variances, mask, eps)

    check_cuda("split_chain", x, (torch.float32, torch.bfloat16), 4, CHANNELS_LAST)
    if weight.dtype != x.dtype or weight.device != x.device:
        raise KernelError("split_chain: weight must match x's dtype and device")
    for st in (*means, *variances):
        check_cuda("split_chain stats", st, (torch.float32,), 1)
        if st.shape[0] != w:
            raise KernelError(f"split_chain: BN stats of {st.shape[0]} channels, width {w}")
    m = None
    if mask is not None:
        m = mask[:, :t].float().contiguous()
        if m.shape != (b, t) or m.device != x.device:
            raise KernelError(f"split_chain: mask {tuple(mask.shape)} does not cover (B, T)=({b}, {t})")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tn = next(n for n in _SPLIT_TN if w % (8 * n) == 0 or n == 1)
    # the tensor-core variants move 16-byte vectors
    plan = split_plan(w, t, f, x.dtype, s) if x.data_ptr() % 16 == 0 else {"variant": "fma"}
    if plan["variant"] == "wgmma":
        return _split_chain_wgmma(x, weight, means, variances, m, out, plan, eps)
    # the other tensor-core variants take the weights as (w*(s-1), 9*w) rows
    # (tap-major, then input channel); the CUDA-core variant reads the JAX
    # layout (3, 3, w, w*(s-1))
    mma = plan["variant"] != "fma"
    wk = (weight.permute(0, 2, 3, 1) if mma else weight.permute(2, 3, 1, 0)).contiguous()
    sms = num_sms(x.device) if plan["variant"] in ("pipe", "fused") else 0
    if plan["variant"] == "fused":
        # (s-1, w) statistics, held until the launch is queued
        bn_mean, bn_var = torch.stack(list(means)), torch.stack(list(variances))
        SPLIT_CONV.launch("split_chain_fused", x.device, plan["nt"], s - 1, ptr(x), ptr(m),
                          ptr(wk), ptr(bn_mean), ptr(bn_var), ptr(out), b, t, f, plan["tt"],
                          plan["tf"], eps, plan["smem"], sms)
        return out
    for i in range(s - 1):
        prev = ptr(out) if i > 0 else None
        shape = (b * t * f, t, f, c, i * w, c, (i - 1) * w, i * w, w,
                 (s - 1) * w, (s - 1) * w, w if i == 0 else 0, eps)
        if plan["variant"] == "pipe":
            SPLIT_CONV.launch("split_group_pipe", x.device, plan["nt"], plan["mt"], ptr(x),
                              prev, ptr(m), ptr(wk), i * w, ptr(means[i]),
                              ptr(variances[i]), ptr(out), b, t, f, plan["tt"], plan["tf"],
                              c, i * w, c, (i - 1) * w, i * w, (s - 1) * w, (s - 1) * w,
                              w if i == 0 else 0, eps, plan["smem"], sms)
        elif mma:
            SPLIT_CONV.launch("split_group_mma", x.device, tn, ptr(x), prev, ptr(m),
                              ptr(wk), i * w, ptr(means[i]), ptr(variances[i]),
                              ptr(out), b, *shape[1:])
        else:
            SPLIT_CONV.launch("split_group", x.device, dtype_code(x.dtype), tn, ptr(x),
                              prev, ptr(m), ptr(wk), w * (s - 1), i * w, ptr(means[i]),
                              ptr(variances[i]), ptr(out), *shape)
    return out


def _split_chain_wgmma(x, weight, means, variances, m, out, plan, eps) -> torch.Tensor:
    """K2's warpgroup-MMA variant, one launch per group: group i stages its
    input from x (i = 0) or from the in_i = x_i + mask * y_{i-1} that group
    i-1's epilogue wrote into one of two scratch tensors (B, T, F, w), and
    writes y_i into out and, but for the last group, in_{i+1} into the
    other. Each group's weights go as (9*w/8, w, 8): [k / 8][output
    channel][k % 8] with k = tap * w + input channel, the K-major core
    matrices of wgmma's B operand."""
    s = len(means) + 1
    b, c, t, f = x.shape
    w = c // s
    wk = (weight.view(s - 1, w, w, 3, 3).permute(0, 3, 4, 2, 1)
          .reshape(s - 1, 9 * w // 8, 8, w).permute(0, 1, 3, 2).contiguous())
    sms = num_sms(x.device)
    scratch = [torch.empty((b, t, f, w), dtype=x.dtype, device=x.device)
               for _ in range(min(2, s - 2))]
    for i in range(s - 1):
        src, stride, off = (x, c, 0) if i == 0 else (scratch[(i - 1) % 2], w, 0)
        nxt = scratch[i % 2] if i < s - 2 else None
        SPLIT_CONV.launch("split_group_wgmma", x.device, w, ptr(x), ptr(src), stride, off,
                          ptr(m), ptr(wk) + i * 9 * w * w * wk.element_size(), ptr(means[i]),
                          ptr(variances[i]), ptr(out), ptr(nxt), b, t, f, plan["tt"],
                          plan["tf"], c, (i + 1) * w, c, i * w, (s - 1) * w, (s - 1) * w,
                          w if i == 0 else 0, eps, plan["smem"], sms)
    return out


# ---------------------------------------------------------------------------
# K10: the stride-2 split stage in eval mode
# ---------------------------------------------------------------------------

_STRIDE2_DESIGNS = ("mma", "vec", "single")
# the mma design's kernel by width (csrc/split_stride2.cu: the instantiated
# kernels), (nsl, nkc, mt, tma, wg, ds): a CTA keeps w / nsl output
# channels' weights resident (nsl = 0: the whole-row form, every group's,
# x's rows in nkc chunks of 64 channels), a ring stage carries w / nkc
# input channels of a tile's x patch (with tma one producer lane's TMA
# boxes, rows of 8-64 channels; else two producer warps' cp.async), the
# consumers run mma.sync (a warp 16 mt rows) or, with wg, wgmma (a
# warpgroup 64 mt rows by the whole slice), and the epilogue stores from
# the accumulators (ds) or through the tile's rows in shared memory. Each is
# the fastest of the forms timed at its width at the registered Res2Nets'
# stride-2 stages (48, 96, 192; 16, 32, 64) on an H100 (scripts/time_k10.py
# --plans; PERF.md); the whole-row form needs s w a multiple of 64
# (s = 4 at w = 48; other splits of 48 have no mma kernel and take vec).
# The thin variants' 8 takes mma.sync.
_STRIDE2_RING = {
    8: (1, 1, 2, 1, 0, 0),
    16: (1, 1, 2, 0, 0, 0),
    32: (1, 1, 1, 1, 1, 0),
    48: (0, 3, 1, 1, 1, 1),
    64: (1, 1, 1, 1, 1, 0),
    96: (1, 3, 1, 1, 1, 1),
    192: (4, 6, 1, 1, 1, 1),
}
# consumer warps a CTA, at most (and one TMA or two cp.async producer warps)
_STRIDE2_CONSUMERS = 8
_SM_SMEM_BYTES = 233472  # an SM's shared memory (228 KB)
_CTA_SMEM_RESERVE = 1024  # the runtime's reserve a CTA


def _stride2_tap_cols(width: int) -> int:
    """K columns of a tap in K10's mma weights: w rounded up to 16
    (csrc/split_stride2.cu:tap_cols)."""
    return -(-width // 16) * 16


def _stride2_wn(width: int, nsl: int, wg: int) -> int:
    """The mma design's warps across a CTA's slice of w / nsl output
    channels (csrc/split_stride2.cu:RingCfg): mma.sync 2 at slices of 64 or
    more; a wgmma warpgroup takes the whole slice (nsl = 0: every group's)."""
    return 2 if not wg and nsl and width // nsl >= 64 else 1


def _stride2_row_bytes(cw: int, tma: int) -> int:
    """Bytes of a staged patch position of cw channels: a TMA box row, or a
    row padded to an odd number of 16-byte units (csrc/split_stride2.cu:
    RingCfg::RS)."""
    return 2 * cw if tma else 2 * _halo_stride(cw)


def _stride2_box(width: int, nkc: int, tma: int, tt: int, tf: int) -> int:
    """Bytes of one of a K10 ring stage's two boxes (the patch's even or odd
    input columns): 2 tt + 1 rows of tf + 1 columns of w / nkc channels
    (csrc/split_stride2.cu:ring_box)."""
    return (2 * tt + 1) * (tf + 1) * _stride2_row_bytes(width // nkc, tma)


def _stride2_smem(width: int, nsl: int, nkc: int, tma: int, wg: int, ds: int, tt: int,
                  tf: int) -> int:
    """Shared memory of K10's mma design (csrc/split_stride2.cu:ring_smem):
    1 KB to align the ring, two ring stages of two boxes each (each 1 KB
    aligned), the slice's weights (mma.sync: w / nsl rows of 9 tap_cols + 8
    K columns; wgmma: 9 tap_cols by w / nsl), the output tile's rows at the
    padded stride (unless ds: the epilogue stores from the accumulators),
    the slice's eval BN (mean, 1 / std), four mbarriers."""
    kt = _stride2_tap_cols(width)
    if nsl == 0:  # the whole row: every conv group's weights and BN
        ng = nkc * 64 // width - 1
        box = -(-(2 * tt + 1) * (tf + 1) * 128 // 1024) * 1024
        return 1024 + 4 * box + ng * 2 * 9 * kt * width + 8 * ng * width + 4 * 8
    box = -(-_stride2_box(width, nkc, tma, tt, tf) // 1024) * 1024
    wsl = width // nsl
    weights = 2 * 9 * kt * wsl if wg else 2 * wsl * (9 * kt + 8)
    rows = 0 if ds else _align16(2 * tt * tf * _halo_stride(wsl))
    return 1024 + 4 * box + weights + rows + 8 * wsl + 4 * 8


def stride2_candidates(width: int, split: int, shape) -> list:
    """Every mma plan of K10 for a stride-2 stage of ``split`` groups of
    width ``width`` on x of ``shape`` (B, s*w, T, F), in
    :func:`stride2_plan`'s order of preference (the first is its pick); empty
    at the widths without a kernel.

    A plan: the width's kernel of ``_STRIDE2_RING`` (``nsl``, ``nkc``,
    ``mt``, ``tma``, ``wg``, ``ds``; ``wn`` mma.sync warps across a CTA's
    slice, ``nt`` n tiles of 8 each), a tile of ``tt`` x ``tf`` output
    positions (F' cut evenly into tiles of at most 16; T' into tiles of at
    most 8 consumer warps' or 2 warpgroups' rows, 227 KB and a TMA box of
    256 rows, then evenly), ``threads`` (the consumers, and one TMA or two
    cp.async producer warps), ``per_sm`` CTAs an SM (two only where shared
    memory and 170 registers a thread allow), ``k`` CTAs per (group,
    slice), each a run of the group's B ``tiles`` (sample, tile) items, as
    many as fit ``PLAN_SMS`` SMs at once. The largest tile at one CTA an
    SM, then at two."""
    b, c, t, f = shape
    if c != split * width or width not in _STRIDE2_RING:
        return []
    nsl, nkc, mt, tma, wg, ds = _STRIDE2_RING[width]
    if nsl == 0 and split * width != 64 * nkc:
        return []  # the whole-row form: rows of nkc chunks of 64 channels
    tout, fout = _strided(t, 2), _strided(f, 2)
    tf = _s2t_even(fout, 16)
    tiles_f = -(-fout // tf)
    wn = _stride2_wn(width, nsl, wg)
    # rows a consumer: a warpgroup of 64 mt (at most 2) or a warp of 16 mt (at
    # most 8 warps)
    rows_per, most = (64 * mt, 2) if wg else (16 * mt, _STRIDE2_CONSUMERS // wn)

    def threads(tt):
        return 32 * ((4 if wg else wn) * -(-tt * tf // rows_per) + 2 - tma)

    largest = {}
    for tt in range(max(1, min(rows_per * most // tf, tout, 127)), 0, -1):
        smem = _stride2_smem(width, nsl, nkc, tma, wg, ds, tt, tf)
        if smem <= _SMEM_BYTES:
            per_sm = min(2 if threads(tt) <= 192 else 1,
                         _SM_SMEM_BYTES // (smem + _CTA_SMEM_RESERVE))
            largest.setdefault(per_sm, tt)
    out = []
    for per_sm in sorted(largest):
        tt = _s2t_even(tout, largest[per_sm])
        tiles = -(-tout // tt) * tiles_f
        out.append({"design": "mma", "nsl": nsl, "nkc": nkc, "mt": mt, "tma": tma, "wg": wg,
                    "ds": ds, "wn": wn, "nt": width // (nsl or 1) // (8 * wn), "tt": tt,
                    "tf": tf, "threads": threads(tt), "per_sm": per_sm,
                    "k": max(1, min(b * tiles, PLAN_SMS * per_sm // ((split - 1) * nsl or 1))),
                    "tiles": tiles, "smem": _stride2_smem(width, nsl, nkc, tma, wg, ds, tt, tf)})
    return out


@functools.lru_cache(maxsize=None)
def stride2_plan(width: int, split: int, shape, dtype: torch.dtype) -> dict:
    """K10's launch plan for a stride-2 stage of ``split`` groups of width
    ``width`` on x of ``shape`` (B, s*w, T, F); output (T', F') =
    ((T-1)//2 + 1, (F-1)//2 + 1). One launch, a function of the shape
    alone.

    ``"mma"`` (bfloat16 where :func:`stride2_candidates` has a plan: its
    first): (split - 1) nsl k persistent CTAs, each a (group, slice of the
    output channels, run of the group's (sample, tile) items) with the
    slice's weights resident (staged from OIHW), the runs' patches on a
    two-stage ring fed by TMA or cp.async producer warps, the MMAs on
    wgmma or mma.sync; the last group's average pool dealt over every CTA
    as stages of their own.

    ``"vec"`` (w fills 16-byte vectors: w % 4 == 0 in float32, % 8 in
    bfloat16) and ``"single"`` (other widths): the FMA designs, 128 output
    positions by 8 ``tn`` output channels a CTA, ``nblk`` channel blocks a
    group, and a column of CTAs for the average pool. The wrapper also needs
    16-byte aligned tensors for mma and vec. Cached per signature and
    shared: callers do not modify a plan."""
    if shape[1] != split * width:
        raise ValueError(f"stride2_plan: shape {tuple(shape)} is not {split} groups of {width}")
    if dtype == torch.bfloat16:
        cands = stride2_candidates(width, split, shape)
        if cands:
            return cands[0]
    return _stride2_fma_plan(width, "vec" if width % (16 // dtype.itemsize) == 0 else "single")


def _stride2_fma_plan(width: int, design: str) -> dict:
    """stride2_plan's FMA designs: ``tn`` output channels a thread (a CTA
    8 tn), ``nblk`` CTAs across a group's w channels."""
    tn = next(n for n in _SPLIT_TN if width % (8 * n) == 0 or n == 1)
    return {"design": design, "tn": tn, "nblk": -(-width // (8 * tn)), "smem": 0}


def _stride2_plan_ints(plan: dict):
    """The plan as the C entry takes it: design, nsl, nkc, mt, tma, wg, ds,
    tt, tf, k, per_sm, tn (csrc/split_stride2.cu:split_stride2)."""
    return (ctypes.c_int * 12)(_STRIDE2_DESIGNS.index(plan["design"]),
                               *(plan.get(k, 0) for k in ("nsl", "nkc", "mt", "tma", "wg", "ds",
                                                          "tt", "tf", "k", "per_sm", "tn")))


def split_stride2_reference(x, weight, means, variances, eps=ops.BN_EPSILON) -> torch.Tensor:
    """Plain version of :func:`split_stride2`, step for step as the JAX
    package's strides > 1 branch (models/res2net.py:52-80): the padded copy,
    one grouped conv at stride 2, eval BN + relu of the s-1 groups, the 3x3
    average pool of the padded last group, the concat."""
    s = len(means) + 1
    w = x.shape[1] // s
    xp = ops.fixed_padding(x, 3)
    y = F.conv2d(xp[:, : w * (s - 1)], weight, stride=2,
                 groups=s - 1).contiguous(memory_format=CHANNELS_LAST)
    y = ops.bn_act_reference(y, torch.cat(list(means)), torch.cat(list(variances)), relu=True,
                             eps=eps)
    tail = ops.avg_pool_3x3(xp[:, w * (s - 1):], 2)
    return torch.cat([y, tail], dim=1).contiguous(memory_format=CHANNELS_LAST)


# stride-2 stage calls by route: in eval "kernel" (K10 on the card) and
# "plain" (CPU tensors); in training "train_kernels" (K11 / K11b on the
# card), "train_plain" (CPU tensors) and "span" (BN groups across data
# ranks: cuDNN's grouped conv + K5's spanning mode + the pool + cat)
_STRIDE2_ROUTES = collections.Counter()
STRIDE2_ROUTES = ("kernel", "plain", "train_kernels", "train_plain", "span")


def split_stride2_route_counts() -> Dict[str, int]:
    return {r: _STRIDE2_ROUTES[r] for r in STRIDE2_ROUTES}


def split_stride2(x: torch.Tensor, weight: torch.Tensor,
                  means: Sequence[torch.Tensor], variances: Sequence[torch.Tensor],
                  eps: float = ops.BN_EPSILON) -> torch.Tensor:
    """Stride-2 Res2Net split stage in eval mode, K10 on CUDA:

        y_i = relu(BN_i(conv3x3_stride2(pad(x_i))))          i < s-1
        y_{s-1} = avg_pool3x3_stride2(pad(x_{s-1}))          the pads counted

    x: (B, s*w, T, F) channels_last; weight: (w*(s-1), w, 3, 3) OIHW in x's
    dtype, group i owning output rows [i*w, (i+1)*w); means/variances: s-1
    float32 (w,) running statistics. Returns (B, s*w, (T-1)//2 + 1,
    (F-1)//2 + 1) channels_last. One launch (:func:`stride2_plan`); a CPU
    tensor takes the plain version, a CUDA one launches the kernel or
    raises."""
    s = len(means) + 1
    b, c, t, f = x.shape
    w = c // s
    if c != s * w or weight.shape != (w * (s - 1), w, 3, 3):
        raise ValueError(f"split_stride2: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} do not make {s} groups of 3x3")
    if x.device.type == "cpu":
        _STRIDE2_ROUTES["plain"] += 1
        return split_stride2_reference(x, weight, means, variances, eps)

    check_cuda("split_stride2", x, (torch.float32, torch.bfloat16), 4, CHANNELS_LAST)
    if weight.dtype != x.dtype or weight.device != x.device:
        raise KernelError("split_stride2: weight must match x's dtype and device")
    for st in (*means, *variances):
        check_cuda("split_stride2 stats", st, (torch.float32,), 1)
        if st.shape[0] != w:
            raise KernelError(f"split_stride2: BN stats of {st.shape[0]} channels, width {w}")
    out = torch.empty((b, _strided(t, 2), _strided(f, 2), c), dtype=x.dtype,
                      device=x.device).permute(0, 3, 1, 2)
    _STRIDE2_ROUTES["kernel"] += 1
    if x.numel() == 0:
        return out
    plan = stride2_plan(w, s, tuple(x.shape), x.dtype)
    weight = weight.contiguous()
    if plan["design"] != "single" and (x.data_ptr() % 16 or weight.data_ptr() % 16):
        # the mma and vec designs move 16-byte vectors
        plan = _stride2_fma_plan(w, "single")
    _stride2_launch(x, weight, means, variances, eps, plan, out)
    return out


def _stride2_launch(x, weight, means, variances, eps, plan, out) -> None:
    """K10's launch on ``plan`` (:func:`stride2_plan`, or any of
    :func:`stride2_candidates`), writing ``out``. The mma design reads the
    OIHW weight as it is; the FMA designs take it in the JAX layout."""
    s = len(means) + 1
    b, c, t, f = x.shape
    w = c // s
    if plan["design"] == "mma":
        wk = weight
    else:
        wk = weight.permute(2, 3, 1, 0).contiguous()  # the JAX layout (3, 3, w, w*(s-1))
    ints = _stride2_plan_ints(plan)
    stats = (ctypes.c_void_p * (2 * (s - 1)))(*(ptr(st) for st in (*means, *variances)))
    SPLIT_STRIDE2.launch("split_stride2", x.device, dtype_code(x.dtype), ctypes.addressof(ints),
                         ptr(x), ptr(wk), ctypes.addressof(stats), ptr(out), b, t, f, s, w, eps,
                         plan["smem"], path=plan["design"])


# ---------------------------------------------------------------------------
# K9 / K9b: the stride-1 split chain in training
# ---------------------------------------------------------------------------

# Slabs a forward / dgrad / statistics launch and the weight gradient's CTAs aim at,
# at w = 8 and at wider groups (more work a patch: fewer, longer slabs);
# chosen by timing the bench step's four stride-1 shapes on an H100
# (PERF.md, PR 15)
_TRAIN_SLAB_CTAS = {8: 1024, 16: 512}
_TRAIN_WGRAD_CTAS = {8: 2048, 16: 1024}
_TRAIN_THREADS = 128
_TRAIN_CO_TILE = 8        # output channels of a float weight-gradient tile
_TRAIN_CI_TILE = 64       # input channels of a float weight-gradient tile, at most
_TRAIN_MMA_MTILES = 8     # m tiles (two (8-channel group, tap) chunks each) of an mma weight tile
# bf16 widths of the mma.sync variant: one pass of w / 8 n tiles covers w
_TRAIN_MMA_W = (8, 16, 24)
_TRAIN_SPLIT_CHUNK = 32   # weight-gradient splits that a first-level sum adds
# split_train_bwd_stats' reduction buffers: 2 channel slots (or, bf16 at
# w % 8 == 0, 8 channels) a thread by two sums
_TRAIN_STATS_SMEM = {False: 4 * 2 * 2 * _TRAIN_THREADS, True: 4 * 2 * 8 * _TRAIN_THREADS}
# The Hopper design (csrc/split_train.cu, "wgmma"): bf16 at these widths;
# persistent CTAs walk about _TRAIN_WG_SLABS slabs, the weight gradient
# takes at most _TRAIN_WG_WGRAD_CTAS CTAs. That count fixes the split of
# positions and so the order in which dW's partials are added: it is a
# constant, not the card's SM count, so that dW is the same bits on every
# card (132 is an H100 SXM's SMs: one wave there, two or more on a card
# with fewer). The weight ring's slices by m tiles a consumer warpgroup
# (_train_wg_mt).
_TRAIN_WGMMA_W = (32, 48, 64, 96, 192)
_TRAIN_WG_SLABS = 512
_TRAIN_WG_WGRAD_CTAS = 132
_TRAIN_WG_RING = {1: 5, 2: 8}
_TRAIN_WG_CONSUMERS = 256


def _train_wg_mt(width: int) -> int:
    """64-row m tiles a consumer warpgroup of the Hopper conv
    (csrc/split_train.cu:wg_mt): two where w / 2 accumulators each fit."""
    return 2 if width <= 96 else 1


def _train_wg_kps(width: int) -> int:
    """k steps of 16 a weight slice (csrc/split_train.cu:wg_kps)."""
    return 2 if _train_wg_mt(width) == 2 and (9 * width // 16) % 2 == 0 else 3


def _train_wg_slice_bytes(width: int) -> int:
    """Bytes of a weight-ring slice (wg_kps k steps of 16 rows of w)."""
    return _train_wg_kps(width) * 16 * width * 2


def _train_wg_slices(width: int) -> int:
    """Slices of the group's 9 w x w weights (csrc/split_train.cu:
    wg_slices): the ring at w <= 64, where they stay resident."""
    return 9 * width // 16 // _train_wg_kps(width)


def _train_wg_wgrad(width: int) -> dict:
    """The Hopper weight gradient's tiles (csrc/split_train.cu: wg_mtiles,
    wg_wmt, wg_nc8): 64-row m tiles of (chunk q = 8-channel group * 9 + tap,
    input channel) rows by all w output channels, ``wmt`` a warpgroup and
    three warpgroups a tile; ``nc8`` 8-channel groups of in_i a tile's halo
    spans at most; ``went`` floats of a tile's partial."""
    nq = 9 * (width // 8)
    mtiles = -(-nq // 8)
    wmt = min(192 // width, -(-mtiles // 3))
    return {"nq": nq, "mtiles": mtiles, "wmt": wmt, "wtiles": -(-mtiles // (3 * wmt)),
            "nc8": min(width // 8, (24 * wmt - 1) // 9 + 2), "went": 192 * wmt * width}


def _train_wg_conv_smem(width: int, hpos: int, ring: int) -> int:
    """Shared memory of the Hopper conv launches (csrc/split_train.cu:
    wg_conv_smem): the weight ring, two halo stages, the consumers' slab-sum
    buffer, the mbarriers."""
    return (ring * _train_wg_slice_bytes(width) + 2 * _align16(hpos * _halo_stride(width) * 2)
            + _TRAIN_WG_CONSUMERS * 16 * 4 + (4 + 2 * ring) * 8)


def _train_wg_wgrad_smem(width: int, wtt: int, tf: int) -> int:
    """Shared memory of the Hopper weight gradient (csrc/split_train.cu:
    wg_wgrad_layout) at patches of wtt x tf: the operands (dz, rows padded
    to 16; in_i's halo of the tile's 8-channel groups), the raw rows of the
    next patch (z_i and d_i; x_i's and z_{i-1}'s halo) and the BN parameter
    table (6 w floats)."""
    pr = -(-(wtt * tf) // 16) * 16
    hpos = (wtt + 2) * (tf + 2)
    nc = 8 * _train_wg_wgrad(width)["nc8"]
    return (3 * _align16(pr * width * 2) + _align16(hpos * _halo_stride(nc) * 2)
            + 2 * _align16(hpos * nc * 2) + 6 * width * 4)


def _align16(v: int) -> int:
    return -(-v // 16) * 16


def _train_mma_raw_bytes(width: int, tt: int, items: int) -> int:
    """The mma variant's raw buffer (csrc/split_train.cu:mma_raw_bytes): two
    16-byte rows an item, the BN parameters (6, w) and tt + 2 mask rows."""
    return 32 * items + 4 * (6 * width + tt + 2)


def _train_conv_smem(width: int, tt: int, tf: int, mma: bool) -> int:
    """Shared memory of K9's conv launches (csrc/split_train.cu:conv_smem):
    the halo patch (bf16 at the padded stride, or float at an odd stride),
    the float variant's weight chunk, the warps' and the slab's sums; the
    mma variant's staged weights and its raw buffer (hpos w / 8 items)."""
    hpos = (tt + 2) * (tf + 2)
    halo = _align16(hpos * _halo_stride(width) * 2) if mma else _align16(hpos * (width | 1) * 4)
    smem = _align16(halo + (0 if mma else 9 * width * _TRAIN_CO_TILE * 4) + 4 * 10 * width)
    if not mma:
        return smem
    return (smem + 2 * width * _weight_stride(width)
            + _train_mma_raw_bytes(width, tt, hpos * (width // 8)))


def _train_wgrad_smem(width: int, tt: int, tf: int, mma: bool) -> int:
    """Shared memory of K9b's weight-gradient role (csrc/split_train.cu:
    wgrad_smem): dz at the patch's positions and in_i's halo for the tile's
    input channels; mma: 128 bf16 rows and the halo, both of all w
    channels, and the raw buffer of 128 + hpos rows of w / 8 items."""
    hpos = (tt + 2) * (tf + 2)
    if mma:
        hs = _halo_stride(width)
        return (_align16(2 * _TRAIN_THREADS * hs) + _align16(2 * hpos * hs)
                + _train_mma_raw_bytes(width, tt, (_TRAIN_THREADS + hpos) * (width // 8)))
    return 4 * (tt * tf * _TRAIN_CO_TILE + hpos * (min(width, _TRAIN_CI_TILE) | 1))


def _train_wgrad_tiles(width: int, mma: bool) -> dict:
    """K9b's weight-gradient tiles (csrc/split_train.cu:make_plan). mma:
    chunks q = 8-channel group * 9 + tap, ``nq`` of them, two a 16-row m
    tile; ``wtiles`` tiles of ``wm`` m tiles by all w output channels;
    float: ``co_tile`` output by ``ci_tile`` input channels, every tap.
    ``went``: floats of a tile's partial."""
    if mma:
        nq = 9 * (width // 8)
        mtiles = -(-nq // 2)
        wtiles = -(-mtiles // _TRAIN_MMA_MTILES)
        wm = -(-mtiles // wtiles)
        return {"nq": nq, "mtiles": mtiles, "wm": wm, "wtiles": wtiles, "went": wm * 16 * width}
    ci_tile = min(width, _TRAIN_CI_TILE)
    co_tiles, ci_tiles = -(-width // _TRAIN_CO_TILE), -(-width // ci_tile)
    return {"co_tile": _TRAIN_CO_TILE, "ci_tile": ci_tile, "co_tiles": co_tiles,
            "ci_tiles": ci_tiles, "wtiles": co_tiles * ci_tiles,
            "went": 9 * ci_tile * _TRAIN_CO_TILE}


@functools.lru_cache(maxsize=None)
def split_train_plan(width: int, split: int, shape, groups: int, dtype: torch.dtype,
                     span: bool = False) -> dict:
    """K9 / K9b's launch plan for a stride-1 chain in training: ``split``
    groups of width ``width`` on x of ``shape`` (B, s*w, T, F), statistics
    over ``groups`` BN groups of B / groups samples.

    ``route``: ``"span"`` where BN groups span data ranks (``span``: the
    chain keeps F.conv2d + K5's spanning mode, nothing else planned), else
    ``"kernels"``, with:

    * ``variant``: ``"wgmma"`` (bfloat16 at w in ``_TRAIN_WGMMA_W``: the
      Hopper design, persistent warp-specialized CTAs on wgmma; ``ring``
      weight slices (all of them, resident, at w <= 64), the patch up to
      128 or 256 rows, the weight
      gradient's tiles :func:`_train_wg_wgrad`), ``"mma"`` (bfloat16 at w in
      ``_TRAIN_MMA_W``: mma.sync, all ``nt`` = w / 8 n tiles in one pass,
      the weights in shared memory) or ``"fma"`` (float32 and the other
      widths, CUDA cores);
    * the patch: ``tt`` x ``tf`` <= 128 positions of one sample (wgmma: 128
      or 256, :func:`_split_train_wg_plan`), F cut evenly into ``ft`` tiles
      of at most 16, ``tt`` as large as the rows and the shared memory
      allow; ``patches`` a sample;
    * the slabs: ``k`` a sample (a run of patches, or of positions for the
      statistics launch, inside one sample: never across a BN group),
      ``slabs`` = B * k a launch, about ``_TRAIN_SLAB_CTAS``'s (fma: one
      CTA a slab; mma: walked by persistent CTAs, as many as fit the card;
      wgmma: about ``_TRAIN_WG_SLABS``, walked by persistent CTAs);
    * the weight gradient (:func:`_train_wgrad_tiles`; wgmma:
      :func:`_train_wg_wgrad`, its own patches of ``wtt`` x ``tf``):
      ``wtiles`` tiles, each summed over ``nsplit`` position splits (CTAs):
      the last of each run of ``_TRAIN_SPLIT_CHUNK`` adds the run in order
      (``nchunks`` runs), the last run the runs;
    * shared memory of each launch (``smem_fwd``, ``smem_stats``,
      ``smem_grad``, <= 227 KB), and the scratch: ``part_floats`` (the
      slabs' (2, w) partials), ``wpart_floats`` (the weight tiles'
      partials), ``tickets`` (one, and nchunks + 1 a weight tile), and the
      backward's folded statistics, double-buffered: ``dy_elems`` (d_i, two
      (B, T, F, w)) and ``stats_floats`` (its sums, two (2, G, w)).

    The C entries recompute the layout from the plan's ints and refuse a
    plan whose shared memory or scratch differs (kPlanMismatch)."""
    if span:
        return {"route": "span"}
    b, c, t, f = shape
    if c != split * width or b % groups:
        raise ValueError(f"split_train_plan: shape {tuple(shape)} is not {split} groups of "
                         f"{width} in {groups} BN groups")
    if width > 256:
        raise ValueError(f"split_train_plan: width {width} > 256")
    # the backward's folded statistics: d_i and its sums (mean(d), mean(d
    # xhat) per BN group and channel), two buffers each
    folded = {"dy_elems": 2 * b * t * f * width, "stats_floats": 2 * 2 * groups * width}
    if dtype == torch.bfloat16 and width in _TRAIN_WGMMA_W:
        return {**_split_train_wg_plan(width, shape), **folded}
    mma = dtype == torch.bfloat16 and width in _TRAIN_MMA_W
    ft = -(-f // 16)
    tf = -(-f // ft)
    for tt in range(max(1, min(_TRAIN_THREADS // tf, t)), 0, -1):
        smem_fwd = _train_conv_smem(width, tt, tf, mma)
        smem_grad = max(smem_fwd, _train_wgrad_smem(width, tt, tf, mma))
        if smem_grad <= _SMEM_BYTES:
            break
    else:
        raise ValueError(f"split_train_plan: width {width} does not fit shared memory")
    patches = -(-t // tt) * ft
    narrow = 8 if width <= 8 else 16
    k = max(1, min(-(-_TRAIN_SLAB_CTAS[narrow] // b), patches))
    tiles = _train_wgrad_tiles(width, mma)
    nsplit = max(1, min(-(-_TRAIN_WGRAD_CTAS[narrow] // tiles["wtiles"]), b * patches))
    nchunks = -(-nsplit // _TRAIN_SPLIT_CHUNK)
    return {"route": "kernels", "variant": "mma" if mma else "fma",
            "nt": width // 8 if mma else 0, "tt": tt, "tf": tf, "ft": ft,
            "patches": patches, "k": k, "slabs": b * k,
            "ci_tile": min(width, _TRAIN_CI_TILE), **tiles, "nsplit": nsplit,
            "nchunks": nchunks, "smem_fwd": smem_fwd, "smem_stats": _TRAIN_STATS_SMEM[mma],
            "smem_grad": smem_grad, "part_floats": b * k * 2 * width,
            "wpart_floats": tiles["wtiles"] * nsplit * tiles["went"],
            "tickets": 1 + tiles["wtiles"] * (nchunks + 1), **folded}


def _even_tile(t: int, cap: int) -> int:
    """The tile of the fewest even tiles of at most ``cap`` that cover t."""
    return -(-t // -(-t // cap))


def _split_train_wg_plan(width: int, shape) -> dict:
    """split_train_plan's ``"wgmma"`` variant: F cut evenly into ``ft``
    tiles of at most 16; T into the fewest even tiles of ``tt`` with tt * tf
    within the conv's rows and its shared memory within 227 KB (``ring``
    weight slices: at w <= 64 all of them, resident (csrc/split_train.cu:
    wg_resident); wider, a ring of ``_TRAIN_WG_RING``'s, fewer only where
    that does not fit), and for the weight
    gradient into even tiles of ``wtt`` (tile rows at most 256, its shared
    memory within 227 KB: ``wpatches`` a sample)."""
    b, _, t, f = shape
    mt = _train_wg_mt(width)
    ft = -(-f // 16)
    tf = -(-f // ft)
    tiles = _train_wg_wgrad(width)
    rings = (_train_wg_slices(width),) if width <= 64 else range(_TRAIN_WG_RING[mt], 1, -1)
    for ring in rings:
        for cap in range(max(1, min(128 * mt // tf, t)), 0, -1):
            tt = _even_tile(t, cap)
            hpos = (tt + 2) * (tf + 2)
            smem_fwd = _train_wg_conv_smem(width, hpos, ring)
            if smem_fwd <= _SMEM_BYTES:
                break
        else:
            continue
        break
    else:
        raise ValueError(f"split_train_plan: width {width} does not fit shared memory")
    for cap in range(max(1, min(256 // tf, t)), 0, -1):
        wtt = _even_tile(t, cap)
        if _train_wg_wgrad_smem(width, wtt, tf) <= _SMEM_BYTES:
            break
    smem_grad = max(smem_fwd, _train_wg_wgrad_smem(width, wtt, tf))
    patches = -(-t // tt) * ft
    wpatches = -(-t // wtt) * ft
    k = max(1, min(-(-_TRAIN_WG_SLABS // b), patches))
    nsplit = max(1, min(_TRAIN_WG_WGRAD_CTAS // tiles["wtiles"], b * wpatches))
    nchunks = -(-nsplit // _TRAIN_SPLIT_CHUNK)
    return {"route": "kernels", "variant": "wgmma", "nt": 0, "ring": ring, "mt": mt, "tt": tt, "tf": tf, "ft": ft, "patches": patches, "k": k,
            "slabs": b * k, "wtt": wtt, "wpatches": wpatches, "ci_tile": wtt, **tiles,
            "nsplit": nsplit, "nchunks": nchunks,
            "smem_fwd": smem_fwd, "smem_stats": _TRAIN_STATS_SMEM[True], "smem_grad": smem_grad,
            "part_floats": b * k * 2 * width,
            "wpart_floats": tiles["wtiles"] * nsplit * tiles["went"],
            "tickets": 1 + tiles["wtiles"] * (nchunks + 1)}


def split_train_slab(plan: dict, shape, slab: int, positions: bool = False):
    """(sample, first, end) of a slab: the patches it walks in the conv
    launches, or (``positions``) the flattened (t, f) positions it sums in
    the statistics launch (csrc/split_train.cu: slab_patches and
    k9b_stats_kernel)."""
    b, k = slab // plan["k"], slab % plan["k"]
    n = shape[2] * shape[3] if positions else plan["patches"]
    return b, n * k // plan["k"], n * (k + 1) // plan["k"]


def _train_plan_ints(plan: dict, shape, split: int, width: int, groups: int):
    """The plan as the C entries take it: csrc/split_train.cu's Plan ints."""
    b, _, t, f = shape
    variant = ("fma", "mma", "wgmma").index(plan["variant"])
    return (ctypes.c_int * 13)(b, t, f, split, width, groups, variant,
                               plan["ring"] if variant == 2 else plan["nt"], plan["tt"],
                               plan["tf"], plan["k"], plan["ci_tile"], plan["nsplit"])


def split_chain_train_reference(x, weight, running_means, running_vars, groups, mask=None,
                                eps=ops.BN_EPSILON, update=True, relu_masks=None,
                                pre_relu=None) -> torch.Tensor:
    """Plain version of :func:`split_chain_train`, step for step as the JAX
    package's stride-1 branch in training (models/res2net.py:82-107): per
    group the conv, training BN over ``groups`` batch groups with relu
    (``ops.bn_train_reference``; the running statistics updated unless
    ``update`` is False), the masked add into the next group; the last group
    passed through. Differentiable by autograd.

    ``relu_masks`` (s-1 tensors shaped as a group's output, 0/1) takes
    those relu decisions in place of the computed ones: a float64 yardstick
    of a run whose decisions at values within rounding of zero went the
    other way (their gradients differ there by the whole upstream value);
    with them, ``pre_relu`` (a list) receives each group's normalized value
    before the decision."""
    s = len(running_means) + 1
    w = x.shape[1] // s
    parts = torch.split(x, w, dim=1)
    outputs = []
    for i in range(s - 1):
        inp = parts[i] if i == 0 else parts[i] + ops.mask_time(outputs[-1], mask)
        y = F.conv2d(inp, weight[i * w: (i + 1) * w], padding=1)
        y = ops.bn_train_reference(y, running_means[i], running_vars[i], groups=groups,
                                   relu=relu_masks is None, eps=eps, update=update)
        if relu_masks is not None:
            if pre_relu is not None:
                pre_relu.append(y.detach())
            y = y * relu_masks[i].to(y.dtype)
        outputs.append(y)
    outputs.append(parts[-1])
    return torch.cat(outputs, dim=1).contiguous(memory_format=CHANNELS_LAST)


def _split_chain_span(x, weight, running_means, running_vars, groups, mask=None,
                      eps=ops.BN_EPSILON):
    """The route where BN groups span data ranks: per group F.conv2d and
    ``ops.bn_train`` (which takes K5's spanning mode on the card)."""
    w = x.shape[1] // (len(running_means) + 1)
    parts = torch.split(x, w, dim=1)
    outputs = []
    for i, (rm, rv) in enumerate(zip(running_means, running_vars)):
        inp = parts[i] if i == 0 else parts[i] + ops.mask_time(outputs[-1], mask)
        y = F.conv2d(inp, weight[i * w: (i + 1) * w], padding=1)
        outputs.append(ops.bn_train(y, rm, rv, groups=groups, relu=True, eps=eps))
    outputs.append(parts[-1])
    return torch.cat(outputs, dim=1).contiguous(memory_format=CHANNELS_LAST)


def _split_train_forward(x, weight, running_means, running_vars, mask, groups, eps, update):
    """K9's s launches: (out, z (s-1, B, T, F, w), stats (s-1, 3, G, w)
    mean, rstd and biased variance per (BN group, channel))."""
    s = len(running_means) + 1
    b, c, t, f = x.shape
    w = c // s
    plan = split_train_plan(w, s, tuple(x.shape), groups, x.dtype)
    ints = _train_plan_ints(plan, x.shape, s, w, groups)
    dev, code = x.device, dtype_code(x.dtype)
    # rows the output channels, K = tap * w + input channel (wgmma:
    # [K / 8][row][K % 8], the core matrices of its B operand)
    wk = weight.view(s - 1, w, w, 3, 3).permute(0, 1, 3, 4, 2)
    wk = _wg_weight_layout(wk, w) if plan["variant"] == "wgmma" else wk.contiguous()
    z = torch.empty((s - 1, b, t, f, w), dtype=x.dtype, device=dev)
    stats = torch.empty((s - 1, 3, groups, w), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    part = stream_scratch(dev, "split_train_part", plan["part_floats"], torch.float32)
    ticket = stream_scratch(dev, "split_train_tickets", plan["tickets"], torch.int32)
    _, upd_mean, upd_var = ops._update_factors(x, groups)
    for i in range(s - 1):
        prev = (ptr(z[i - 1]), ptr(stats[i - 1])) if i else (None, None)
        run = (ptr(running_means[i]), ptr(running_vars[i])) if update else (None, None)
        SPLIT_TRAIN.launch("split_train_fwd", dev, code, i, ctypes.addressof(ints), ptr(x), *prev,
                           ptr(mask), ptr(wk[i]), ptr(z[i]), ptr(stats[i]), *run, ptr(out),
                           ptr(part), ptr(ticket), eps, ops.BN_MOMENTUM, upd_mean, upd_var,
                           plan["smem_fwd"])
    SPLIT_TRAIN.launch("split_train_finish", dev, code, ctypes.addressof(ints), ptr(z[s - 2]),
                       ptr(stats[s - 2]), ptr(out))
    return out, z, stats


def _wg_weight_layout(wk: torch.Tensor, w: int) -> torch.Tensor:
    """(s-1, rows, 3, 3, w) weights as the Hopper conv's B operand: (s-1, 9 w
    / 8, rows, 8), [K / 8][row][K % 8] with K = tap * w + channel."""
    n = wk.shape[0]
    return wk.reshape(n, w, 9 * w // 8, 8).permute(0, 2, 1, 3).contiguous()


def _split_train_backward(x, weight, z, stats, mask, groups, dout):
    """K9b's s launches: group s-2's statistics, then one a group, i = s-2
    .. 0, each with group i-1's statistics folded in (d_{i-1} and its sums
    double-buffered: group i reads one half while it writes the other).
    Returns (dx, the weight's gradient in x's dtype)."""
    s = z.shape[0] + 1
    b, c, t, f = x.shape
    w = c // s
    plan = split_train_plan(w, s, tuple(x.shape), groups, x.dtype)
    ints = _train_plan_ints(plan, x.shape, s, w, groups)
    dev, code = x.device, dtype_code(x.dtype)
    dout = ops.aligned_operand(dout)
    # the transposed conv is the conv with flipped weights, rows the input
    # channels, K = tap * w + output channel
    wkb = weight.view(s - 1, w, w, 3, 3).flip(3, 4).permute(0, 2, 3, 4, 1)
    wkb = _wg_weight_layout(wkb, w) if plan["variant"] == "wgmma" else wkb.contiguous()
    dx = torch.empty_like(x)
    dweight = torch.empty(weight.shape, dtype=x.dtype, device=dev)
    dy = torch.empty(plan["dy_elems"], dtype=x.dtype, device=dev).view(2, b, t, f, w)
    bsums = torch.empty(plan["stats_floats"], dtype=torch.float32, device=dev).view(2, 2, groups, w)
    part = stream_scratch(dev, "split_train_part", plan["part_floats"], torch.float32)
    tickets = stream_scratch(dev, "split_train_tickets", plan["tickets"], torch.int32)
    wpart = stream_scratch(dev, "split_train_wpart", plan["wpart_floats"], torch.float32)
    last = s - 2
    SPLIT_TRAIN.launch("split_train_bwd_stats", dev, code, last, ctypes.addressof(ints),
                       ptr(dout), ptr(dx), ptr(z[last]), ptr(stats[last]), ptr(mask),
                       ptr(dy[last % 2]), ptr(part), ptr(tickets), ptr(bsums[last % 2]),
                       plan["smem_stats"])
    for i in reversed(range(s - 1)):
        prev = (ptr(z[i - 1]), ptr(stats[i - 1])) if i else (None, None)
        fold = ((ptr(dout), ptr(dy[(i - 1) % 2]), ptr(bsums[(i - 1) % 2]), ptr(part),
                 ptr(tickets)) if i else (None,) * 5)
        SPLIT_TRAIN.launch("split_train_bwd_grad", dev, code, i, ctypes.addressof(ints), ptr(x),
                           *prev, ptr(mask), ptr(z[i]), ptr(stats[i]), ptr(bsums[i % 2]),
                           ptr(dy[i % 2]), ptr(wkb[i]), ptr(dx), ptr(dweight), ptr(wpart),
                           ptr(tickets) + 4, *fold, plan["smem_grad"], wpart.numel())
    return dx, dweight


@torch.library.custom_op(
    "vsv_torch::split_train_fwd", mutates_args=("running_means", "running_vars"),
    schema="(Tensor x, Tensor weight, Tensor(a!)[] running_means, Tensor(b!)[] running_vars, "
           "Tensor? mask, int groups, float eps, bool update) -> (Tensor, Tensor, Tensor)")
def split_train_fwd_op(x, weight, running_means, running_vars, mask, groups, eps, update):
    """K9 as one operator (out, z, stats), so that a selective checkpoint can
    name it: under ``dots_saveable`` the recompute takes its outputs from
    the first forward (:data:`_SAVED_BY_DOTS`)."""
    return _split_train_forward(x, weight, running_means, running_vars, mask, groups, eps,
                                update)


class _SplitTrainFn(torch.autograd.Function):
    """K9 forward, K9b backward. Saves x, the weight, the s-1 conv outputs
    z_i and their statistics; the running statistics are updated in place
    by the forward (unless ``update`` is False) and take no gradient."""

    @staticmethod
    def forward(ctx, x, weight, mask, running_means, running_vars, groups, eps, update):
        out, z, stats = split_train_fwd_op(x, weight, list(running_means), list(running_vars),
                                           mask, groups, eps, update)
        ctx.save_for_backward(x, weight, z, stats, mask)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, dout):
        x, weight, z, stats, mask = ctx.saved_tensors
        dx, dweight = _split_train_backward(x, weight, z, stats, mask, ctx.groups, dout)
        return dx, dweight, None, None, None, None, None, None


# chain calls by route: "kernels" (K9 / K9b on the card), "span" (BN groups
# across data ranks: F.conv2d + K5's spanning mode), "plain" (CPU tensors)
_TRAIN_ROUTES = collections.Counter()


def split_train_route_counts() -> Dict[str, int]:
    return {r: _TRAIN_ROUTES[r] for r in ("kernels", "span", "plain")}


def reset_split_train_routes() -> None:
    _TRAIN_ROUTES.clear()


def split_chain_train(x: torch.Tensor, weight: torch.Tensor,
                      running_means: Sequence[torch.Tensor],
                      running_vars: Sequence[torch.Tensor], groups: int = 1,
                      mask: Optional[torch.Tensor] = None,
                      eps: float = ops.BN_EPSILON) -> torch.Tensor:
    """Stride-1 Res2Net split chain in training, K9 / K9b on CUDA:

        y_i = relu(BN_g(conv3x3_same(x_i + mask * y_{i-1})))   i < s-1
        y_{s-1} = x_{s-1}

    BN_g: statistics per batch group (``groups``, the model's bn_groups),
    the running statistics (s-1 float32 (w,) tensors) updated in place
    unless inside ``ops.running_update(False)``. x: (B, s*w, T, F)
    channels_last; weight: (w*(s-1), w, 3, 3) OIHW in x's dtype; mask: (B,
    T') 0/1 with T' >= T. Differentiable in x and the weight.

    Inside a step whose mesh has data ranks, ``groups`` counts the global
    batch's groups (as ``ops.bn_train``): groups inside each rank run here
    as ``groups / ranks``; groups that span ranks take the ``"span"`` route,
    chosen from the mesh. A CPU tensor takes the plain version; a CUDA one
    launches the kernels or raises."""
    s = len(running_means) + 1
    b, c, t, f = x.shape
    w = c // s
    if c != s * w or weight.shape != (w * (s - 1), w, 3, 3):
        raise ValueError(f"split_chain_train: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} do not make {s} groups of 3x3")
    update = ops.running_update_enabled()
    mesh = active_mesh()
    if mesh is not None and mesh.num_data > 1:
        if groups % mesh.num_data:
            _TRAIN_ROUTES["span"] += 1
            return _split_chain_span(x, weight, running_means, running_vars, groups, mask, eps)
        groups //= mesh.num_data  # every group inside this rank
    if b % groups:
        raise ValueError(f"batch {b} not divisible into {groups} BN groups")
    if x.device.type == "cpu":
        _TRAIN_ROUTES["plain"] += 1
        return split_chain_train_reference(x, weight, running_means, running_vars, groups, mask,
                                           eps, update)
    check_cuda("split_chain_train", x, (torch.float32, torch.bfloat16), 4, CHANNELS_LAST)
    if weight.dtype != x.dtype or weight.device != x.device:
        raise KernelError("split_chain_train: weight must match x's dtype and device")
    for st in (*running_means, *running_vars):
        check_cuda("split_chain_train stats", st, (torch.float32,), 1)
        if st.shape[0] != w:
            raise KernelError(f"split_chain_train: BN stats of {st.shape[0]} channels, width {w}")
    if x.numel() == 0:
        raise KernelError("split_chain_train: empty batch")
    m = None
    if mask is not None:
        m = mask[:, :t].float().contiguous()
        if m.shape != (b, t) or m.device != x.device:
            raise KernelError(f"split_chain_train: mask {tuple(mask.shape)} does not cover "
                              f"(B, T)=({b}, {t})")
    _TRAIN_ROUTES["kernels"] += 1
    return _SplitTrainFn.apply(ops.aligned_operand(x), weight, m, tuple(running_means),
                               tuple(running_vars), groups, eps, update)


# ---------------------------------------------------------------------------
# K11 / K11b: the stride-2 split stage in training
# ---------------------------------------------------------------------------

_S2T_FMA_THREADS = 128
_S2T_FMA_TM = 8          # rows a thread of the FMA convs, at most
_S2T_RED_FLOATS = 2 * _S2T_FMA_THREADS * 4
_S2T_SLABS = 1024        # FMA conv slabs and statistics slabs a launch, about
# FMA weight-gradient CTAs a launch, about. It fixes the split of the tiles and
# so the order in which dW's partials are added: a constant, not the card's
# SM count, so that dW is the same bits on every card
_S2T_WGRAD_CTAS = 384
_S2T_MAX_UPT = 8         # (tap, channel) rows an FMA weight-gradient thread
_S2T_POOL_CTAS = 1056    # the average pool's backward CTAs (of 256 threads), at most
# the mma design (csrc/split_stride2_train.cu: fwd_nsl, fwd_nkc): per width,
# the forward's slices of a group's output channels (a CTA's resident
# weights) and chunks of its input channels (a ring stage's x patch)
_S2T_FWD_SLICES = {8: (1, 1), 16: (1, 1), 32: (1, 1), 48: (1, 1), 64: (1, 1), 96: (2, 1),
                   192: (4, 4)}
# and the grad launch's (warps, dgrad slices nds, warps across a slice):
# nds 1, the dgrad weights whole and each tile's dgrad on one chunk's CTA;
# else chunk c < nds the dgrad of dx's 16-channel slice c
_S2T_GRAD_WARPS = {8: (4, 1, 1), 16: (4, 1, 1), 32: (8, 1, 2), 48: (8, 1, 2), 64: (8, 1, 2),
                   96: (8, 6, 2), 192: (8, 12, 2)}
# the dgrad's tap slots (kt, kf), by parity class of the input position:
# (even, even) (1,1); (even, odd) (1,0) (1,2); (odd, even) (0,1) (2,1);
# (odd, odd) (0,0) (0,2) (2,0) (2,2) (csrc/split_stride2_train.cu)
_S2T_DGRAD_TAPS = ((1, 1), (1, 0), (1, 2), (0, 1), (2, 1), (0, 0), (0, 2), (2, 0), (2, 2))


def _s2t_patch_bytes(tt: int, tf: int, xs: int, itemsize: int, halo: bool) -> int:
    """Bytes of a staged patch (csrc/split_stride2_train.cu: xpatch_bytes,
    dpatch_bytes): the x patch of a tt x tf output tile ((2 tt + 1) x (2 tf
    + 1) input positions) or its dz patch ((tt + 1) x (tf + 1) output
    positions), at a row stride of xs elements."""
    pos = (2 * tt + 1) * (2 * tf + 1) if halo else (tt + 1) * (tf + 1)
    return _align16(pos * xs * itemsize)


def _s2t_fwd_wn(width: int) -> int:
    """The mma forward's warps across a slice of the output channels (8 nt
    channels each; csrc/split_stride2_train.cu: fwd_wn): 2 at slices of 32
    or more."""
    return 2 if width // _S2T_FWD_SLICES[width][0] >= 32 else 1


def _s2t_mma_wgrad(width: int):
    """The mma weight gradient (csrc/split_stride2_train.cu: wg_nchunks,
    wg_upt): m tiles of (tap, 16 input channels), 9 ceil(w / 16); ``upt`` a
    warp (at most 96 accumulator registers a thread at w <= 64, 64 above, w
    / 2 an m tile, or one), a chunk the CTA's warps' (chunk c: m tiles c, c
    + nchunks, ...). Returns (m tiles, upt, nchunks)."""
    warps = _S2T_GRAD_WARPS[width][0]
    mtiles = 9 * -(-width // 16)
    regs = 192 if width <= 64 else 128
    nchunks = -(-mtiles // (warps * min(-(-mtiles // warps), max(1, regs // width))))
    return mtiles, -(-mtiles // (nchunks * warps)), nchunks


def _s2t_smem(width: int, tt: int, tf: int, design: str, itemsize: int, threads: int = 0,
              gtt: int = 0):
    """(forward, grad) shared memory of K11 / K11b's conv launches
    (csrc/split_stride2_train.cu: fwd_smem, grad_smem). mma: the forward's
    slice of the weights (rows of 9 tap_cols + 8), two ring stages of the x
    patch (a chunk of the input channels) and the warps' sums; the grad's
    dgrad slice of the weights, two ring stages of the x patch and of raw
    dout and z (gtt x tf tiles), the dz patch with a zero row after it, the
    weight gradient's row tables and a BN group's 4 w parameters. fma: a
    tap's weights as floats, the threads' sums and the x patch; the larger
    of the x and dz patches (the weight gradient) and a tap's weights and
    the dz patch (the dgrad)."""
    if design == "mma":
        nsl, nkc = _S2T_FWD_SLICES[width]
        kt = _stride2_tap_cols(width)
        fwd = (2 * (width // nsl) * (9 * kt + 8)
               + 2 * _s2t_patch_bytes(tt, tf, _halo_stride(width // nkc), 2, True)
               + 8 * (threads // 32 // _s2t_fwd_wn(width)) * (width // nsl))
        nds = _S2T_GRAD_WARPS[width][1]
        hs = _halo_stride(width)
        grad = (2 * (width // nds) * (9 * kt + 8)
                + 2 * (_s2t_patch_bytes(gtt, tf, hs, 2, True)
                       + _align16(4 * (gtt + 1) * (tf + 1) * width))
                + _align16(((gtt + 1) * (tf + 1) + 1) * hs * 2) + 2 * 4 * 16 * -(-gtt * tf // 16)
                + 16 * width)
        return fwd, grad
    xs = width | 1
    wbytes = _align16(4 * width * width)
    fwd = wbytes + 4 * _S2T_RED_FLOATS + _s2t_patch_bytes(tt, tf, xs, itemsize, True)
    grad = max(_s2t_patch_bytes(tt, tf, xs, itemsize, True)
               + _s2t_patch_bytes(tt, tf, xs, itemsize, False),
               wbytes + _s2t_patch_bytes(tt, tf, xs, itemsize, False))
    return fwd, grad


def _s2t_even(n: int, most: int) -> int:
    """The tile extent of at most ``most`` that cuts ``n`` into the fewest
    pieces, evened out over them."""
    return -(-n // -(-n // most))


def _s2t_per_sm(smem: int, threads: int) -> int:
    """CTAs of ``smem`` bytes and ``threads`` threads that fit one SM."""
    return max(1, min(_SM_SMEM_BYTES // (smem + _CTA_SMEM_RESERVE), 2048 // threads, 32))


@functools.lru_cache(maxsize=None)
def stride2_train_plan(width: int, split: int, shape, groups: int, dtype: torch.dtype) -> dict:
    """K11 / K11b's launch plan for a stride-2 stage in training: ``split``
    groups of width ``width`` on x of ``shape`` (B, s*w, T, F), statistics
    over ``groups`` BN groups of B / groups samples; output (T', F') =
    ((T-1)//2 + 1, (F-1)//2 + 1).

    * ``design``: ``"mma"`` (bfloat16 at the widths of ``_S2T_FWD_SLICES``:
      persistent CTAs on mma.sync) or ``"fma"`` (float32 and the other
      widths: 128 threads, a thread 8 rows by ``tn`` channels);
    * the forward's output tile: ``tt`` x ``tf`` positions of one
      utterance, F' cut evenly into tiles of at most 16; mma: ``tt`` as
      large as 128 rows (four warps of 32) and 227 KB allow with two ring
      stages, then evened out over T', ``threads`` a warp per 32 rows and
      8 nt channels (``_s2t_fwd_wn`` warps across a slice); ``nsl`` slices
      of the output channels and ``nkc`` chunks of the input channels
      (``_S2T_FWD_SLICES``); ``k`` CTAs per (group, slice), each a run of
      the group's B x ``tiles`` (sample, tile) items, as many as fit
      ``PLAN_SMS`` SMs at once (one wave) and at least ``groups`` (a run
      then touches at most two BN groups: its partials); fma: ``k`` runs of
      tiles (slabs) a sample, about ``_S2T_SLABS`` a launch;
    * the grad launch: mma, ``gthreads`` (``_S2T_GRAD_WARPS``), tiles of
      ``gtt`` x ``tf`` (``gtiles`` a sample) as large as the dgrad's rows
      and 227 KB allow, ``upt`` dW m tiles a warp and ``nchunks`` chunks
      (``_s2t_mma_wgrad``), ``nds`` dgrad slices, ``nsplit`` CTAs per
      (group, chunk) each a run of the group's tiles, as many as fit
      ``PLAN_SMS`` SMs at once (one wave); fma, ``pc`` (tap, channel) rows
      a chunk, ``nb`` blocks of 4 output channels, ``pg`` = threads / nb
      pair groups, ``upt`` rows a thread, ``nsplit`` splits of the tiles a
      chunk (about ``_S2T_WGRAD_CTAS`` CTAs a launch). Either way
      ``nsplit`` fixes the order in which dW's partials are added, by the
      shape alone;
    * ``kstat`` runs of positions a sample in the statistics launch (a slab
      never straddles a BN group), ``pool_ctas`` CTAs for the pool's
      backward beside them;
    * shared memory (``smem_fwd``, ``smem_grad``) and scratch:
      ``part_floats`` (BN partials), ``tickets``, ``wpart_floats``.

    The C entries recompute the layout from the plan's ints and refuse a
    plan whose shared memory differs (kPlanMismatch). Cached per signature
    and shared: callers do not modify a plan."""
    b, c, t, f = shape
    if c != split * width or not 2 <= split <= 9 or b % groups:
        raise ValueError(f"stride2_train_plan: shape {tuple(shape)} is not {split} groups of "
                         f"{width} in {groups} BN groups")
    if width > 256:
        raise ValueError(f"stride2_train_plan: width {width} > 256")
    tout, fout = _strided(t, 2), _strided(f, 2)
    tf = _s2t_even(fout, 16)
    tiles_f = -(-fout // tf)
    itemsize = 2 if dtype == torch.bfloat16 else 4
    ng = split - 1
    plan = {"tf": tf}
    if dtype == torch.bfloat16 and width in _S2T_FWD_SLICES:
        nsl, nkc = _S2T_FWD_SLICES[width]
        gwarps, nds, wnd = _S2T_GRAD_WARPS[width]
        wn = _s2t_fwd_wn(width)
        fits = [tt for tt in range(max(1, min(128 // tf, tout)), 0, -1)
                if _s2t_smem(width, tt, tf, "mma", 2, 32 * wn * -(-tt * tf // 32), 1)[0]
                <= _SMEM_BYTES]
        if not fits:
            raise ValueError(f"stride2_train_plan: width {width} does not fit shared memory")
        tt = _s2t_even(tout, fits[0])
        threads = 32 * wn * -(-tt * tf // 32)
        gfits = [g for g in range(max(1, min(32 * (gwarps // wnd) // tf, tout)), 0, -1)
                 if _s2t_smem(width, 1, tf, "mma", 2, 32, g)[1] <= _SMEM_BYTES]
        if not gfits:
            raise ValueError(f"stride2_train_plan: width {width} does not fit shared memory")
        gtt = _s2t_even(tout, gfits[0])
        smem_fwd, smem_grad = _s2t_smem(width, tt, tf, "mma", 2, threads, gtt)
        tiles, gtiles = -(-tout // tt) * tiles_f, -(-tout // gtt) * tiles_f
        _, upt, nchunks = _s2t_mma_wgrad(width)
        gthreads = 32 * gwarps
        k = min(b * tiles, max(groups, PLAN_SMS * _s2t_per_sm(smem_fwd, threads) // (ng * nsl)))
        # the last CTA's table of the runs (2 k + 2 G ints) in the two ring stages
        k = min(k, _s2t_patch_bytes(tt, tf, _halo_stride(width // nkc), 2, True) // 4 - groups)
        if k < groups:
            raise ValueError(f"stride2_train_plan: shape {tuple(shape)} leaves no room for "
                             f"{groups} BN groups' runs")
        nsplit = min(b * gtiles,
                     max(1, PLAN_SMS * _s2t_per_sm(smem_grad, gthreads) // (ng * nchunks)))
        nconv = ng * nsl * k
        plan.update(design="mma", tn=0, threads=threads, tt=tt, nsl=nsl, nkc=nkc, k=k,
                    tiles=tiles, gtt=gtt, gtiles=gtiles, gthreads=gthreads, nds=nds, nb=0, pg=0,
                    upt=upt, pc=gwarps * upt * 16, nchunks=nchunks, nsplit=nsplit, nconv=nconv,
                    smem_fwd=smem_fwd, smem_grad=smem_grad)
        fwd_part = ng * k * 2 * 2 * width
    else:
        tn = 4 if width % 4 == 0 else 1
        nbk = -(-width // tn)
        if nbk > _S2T_FMA_THREADS:
            raise ValueError(f"stride2_train_plan: width {width} needs 4-channel vectors")
        rows_max = min(128, (_S2T_FMA_THREADS // nbk) * _S2T_FMA_TM)
        found = None
        for tt in range(max(1, min(rows_max // tf, tout)), 0, -1):
            smem = _s2t_smem(width, tt, tf, "fma", itemsize)
            if max(smem) <= _SMEM_BYTES:
                found = (tt, *smem)
                break
        if found is None:
            raise ValueError(f"stride2_train_plan: width {width} does not fit shared memory")
        tt, smem_fwd, smem_grad = found
        tiles = -(-tout // tt) * tiles_f
        k = max(1, min(-(-_S2T_SLABS // (ng * b)), tiles))
        nb = -(-width // 4)
        pg = _S2T_FMA_THREADS // nb
        upt = min(_S2T_MAX_UPT, -(-9 * width // pg))
        pc = pg * upt
        nchunks = -(-9 * width // pc)
        nsplit = max(1, min(b * tiles, -(-_S2T_WGRAD_CTAS // (ng * nchunks))))
        nconv = ng * b * k
        plan.update(design="fma", tn=tn, threads=_S2T_FMA_THREADS, tt=tt, nsl=0, nkc=0, k=k,
                    tiles=tiles, gtt=tt, gtiles=tiles, gthreads=_S2T_FMA_THREADS, nds=0, nb=nb,
                    pg=pg, upt=upt, pc=pc, nchunks=nchunks, nsplit=nsplit, nconv=nconv,
                    smem_fwd=smem_fwd, smem_grad=smem_grad)
        fwd_part = nconv * 2 * width
    kstat = max(1, min(-(-_S2T_SLABS // (ng * b)), tout * fout))
    vec = 16 // itemsize if width % (16 // itemsize) == 0 else 1
    nstat, nwgrad = ng * b * kstat, ng * plan["nchunks"] * plan["nsplit"]
    plan.update(kstat=kstat, nstat=nstat, nwgrad=nwgrad,
                pool_ctas=max(1, min(_S2T_POOL_CTAS, -(-b * t * f * (width // vec) // 256))),
                part_floats=max(fwd_part, nstat * 2 * width), tickets=ng * plan["nchunks"],
                wpart_floats=nwgrad * plan["pc"] * width)
    return plan


def _stride2_train_ints(plan: dict, shape, split: int, width: int, groups: int):
    """The plan as the C entries take it (csrc/split_stride2_train.cu:
    make_plan): 20 ints."""
    b, _, t, f = shape
    return (ctypes.c_int * 20)(b, t, f, split, width, groups, ("fma", "mma").index(plan["design"]),
                               plan["tt"], plan["tf"], plan["k"], plan["kstat"],
                               plan["pool_ctas"], plan["nsplit"], plan["upt"], plan["nsl"],
                               plan["nkc"], plan["threads"], plan["gtt"], plan["gthreads"],
                               plan["nds"])


def split_stride2_train_reference(x, weight, running_means, running_vars, groups=1,
                                  eps=ops.BN_EPSILON, update=True, relu_masks=None,
                                  pre_relu=None) -> torch.Tensor:
    """Plain version of :func:`split_stride2_train`, step for step as the
    JAX package's strides > 1 branch in training (models/res2net.py:52-80):
    the padded copy, one grouped conv at stride 2 (its output in x's dtype),
    per group training BN over ``groups`` batch groups with relu
    (``ops.bn_train_reference``: its running update counts the output's
    rows, (B / G) T' F'; none where ``update`` is False), the 3x3 average
    pool of the padded last group, the concat. Differentiable by autograd.

    ``relu_masks`` (s-1 tensors shaped as a group's output, 0/1) takes those
    relu decisions in place of the computed ones (a float64 yardstick of a
    run whose decisions near zero went the other way); with them,
    ``pre_relu`` (a list) receives each group's normalized value before the
    decision."""
    s = len(running_means) + 1
    w = x.shape[1] // s
    xp = ops.fixed_padding(x, 3)
    z = F.conv2d(xp[:, : w * (s - 1)], weight, stride=2, groups=s - 1)
    outputs = []
    for i in range(s - 1):
        y = ops.bn_train_reference(z[:, i * w: (i + 1) * w], running_means[i], running_vars[i],
                                   groups=groups, relu=relu_masks is None, eps=eps,
                                   update=update)
        if relu_masks is not None:
            if pre_relu is not None:
                pre_relu.append(y.detach())
            y = y * relu_masks[i].to(y.dtype)
        outputs.append(y)
    outputs.append(ops.avg_pool_3x3(xp[:, w * (s - 1):], 2))
    return torch.cat(outputs, dim=1).contiguous(memory_format=CHANNELS_LAST)


def _split_stride2_span(x, weight, running_means, running_vars, groups, eps=ops.BN_EPSILON):
    """The route where BN groups span data ranks: the padded copy, cuDNN's
    grouped conv at stride 2, ``ops.bn_train`` over all s-1 groups at once
    (statistics are per channel; on the card K5's spanning mode) with the
    running statistics copied back, the average pool, the concat."""
    s = len(running_means) + 1
    w = x.shape[1] // s
    xp = ops.fixed_padding(x, 3)
    y = F.conv2d(xp[:, : w * (s - 1)], weight, stride=2,
                 groups=s - 1).contiguous(memory_format=CHANNELS_LAST)
    mean, var = torch.cat(list(running_means)), torch.cat(list(running_vars))
    y = ops.bn_train(y, mean, var, groups=groups, relu=True, eps=eps)
    if ops.running_update_enabled():
        with torch.no_grad():  # the update ran on the concatenated copy
            for i, (rm, rv) in enumerate(zip(running_means, running_vars)):
                rm.copy_(mean[i * w: (i + 1) * w])
                rv.copy_(var[i * w: (i + 1) * w])
    tail = ops.avg_pool_3x3(xp[:, w * (s - 1):], 2)
    return torch.cat([y, tail], dim=1).contiguous(memory_format=CHANNELS_LAST)


def _split_stride2_train_forward(x, weight, running_means, running_vars, groups, eps, update):
    """K11's two launches on :func:`stride2_train_plan`'s plan (the conv
    and the BN statistics; the normalization and the tail's average pool),
    reading the OIHW weight as it is: (out, z (s-1, B, T', F', w), stats
    (s-1, 3, G, w) mean, rstd and biased variance per (BN group,
    channel))."""
    s = len(running_means) + 1
    b, c, t, f = x.shape
    w = c // s
    tout, fout = _strided(t, 2), _strided(f, 2)
    plan = stride2_train_plan(w, s, tuple(x.shape), groups, x.dtype)
    ints = _stride2_train_ints(plan, x.shape, s, w, groups)
    dev, code = x.device, dtype_code(x.dtype)
    weight = weight.contiguous()
    z = torch.empty((s - 1, b, tout, fout, w), dtype=x.dtype, device=dev)
    stats = torch.empty((s - 1, 3, groups, w), dtype=torch.float32, device=dev)
    out = torch.empty((b, tout, fout, c), dtype=x.dtype, device=dev).permute(0, 3, 1, 2)
    part = stream_scratch(dev, "split_stride2_train_part", plan["part_floats"], torch.float32)
    tickets = stream_scratch(dev, "split_stride2_train_tickets", plan["tickets"], torch.int32)
    # the running update counts the output's rows of a BN group
    _, upd_mean, upd_var = ops._update_factors(x, groups, n=(b // groups) * tout * fout)
    run = ((ctypes.c_void_p * (2 * (s - 1)))(*(ptr(r) for r in (*running_means, *running_vars)))
           if update else None)
    SPLIT_STRIDE2_TRAIN.launch("split_stride2_train_fwd", dev, code, ctypes.addressof(ints),
                               ptr(x), ptr(weight), ptr(z), ptr(stats),
                               None if run is None else ctypes.addressof(run), ptr(out),
                               ptr(part), ptr(tickets), eps, ops.BN_MOMENTUM, upd_mean, upd_var,
                               plan["smem_fwd"])
    SPLIT_STRIDE2_TRAIN.launch("split_stride2_train_finish", dev, code, ctypes.addressof(ints),
                               ptr(x), ptr(z), ptr(stats), ptr(out))
    return out, z, stats


def _split_stride2_train_backward(x, weight, z, stats, groups, dout):
    """K11b's two launches on the forward's plan: the sums of d and d
    xhat with the pool's backward, then dz with the parity-gathered dgrad
    and the weight gradient. Returns (dx, the weight's gradient in x's
    dtype)."""
    s = z.shape[0] + 1
    b, c, t, f = x.shape
    w = c // s
    plan = stride2_train_plan(w, s, tuple(x.shape), groups, x.dtype)
    ints = _stride2_train_ints(plan, x.shape, s, w, groups)
    dev, code = x.device, dtype_code(x.dtype)
    dout = ops.aligned_operand(dout)
    weight = weight.contiguous()
    dx = torch.empty_like(x)
    dweight = torch.empty(weight.shape, dtype=x.dtype, device=dev)
    bsums = torch.empty((s - 1, 2, groups, w), dtype=torch.float32, device=dev)
    part = stream_scratch(dev, "split_stride2_train_part", plan["part_floats"], torch.float32)
    tickets = stream_scratch(dev, "split_stride2_train_tickets", plan["tickets"], torch.int32)
    wpart = stream_scratch(dev, "split_stride2_train_wpart", plan["wpart_floats"], torch.float32)
    SPLIT_STRIDE2_TRAIN.launch("split_stride2_train_bwd_stats", dev, code,
                               ctypes.addressof(ints), ptr(dout), ptr(z), ptr(stats), ptr(bsums),
                               ptr(part), ptr(tickets), ptr(dx))
    SPLIT_STRIDE2_TRAIN.launch("split_stride2_train_bwd_grad", dev, code, ctypes.addressof(ints),
                               ptr(x), ptr(dout), ptr(z), ptr(stats), ptr(bsums), ptr(weight),
                               ptr(dx), ptr(dweight), ptr(wpart), ptr(tickets),
                               plan["smem_grad"])
    return dx, dweight


@torch.library.custom_op(
    "vsv_torch::split_stride2_train_fwd", mutates_args=("running_means", "running_vars"),
    schema="(Tensor x, Tensor weight, Tensor(a!)[] running_means, Tensor(b!)[] running_vars, "
           "int groups, float eps, bool update) -> (Tensor, Tensor, Tensor)")
def split_stride2_train_fwd_op(x, weight, running_means, running_vars, groups, eps, update):
    """K11 as one operator (out, z, stats), so that a selective checkpoint
    can name it: under ``dots_saveable`` the recompute takes its outputs
    from the first forward (:data:`_SAVED_BY_DOTS`)."""
    return _split_stride2_train_forward(x, weight, running_means, running_vars, groups, eps,
                                        update)


class _SplitStride2TrainFn(torch.autograd.Function):
    """K11 forward, K11b backward. Saves x, the weight, the s-1 conv outputs
    z_i and their statistics; the running statistics are updated in place
    by the forward (unless ``update`` is False) and take no gradient."""

    @staticmethod
    def forward(ctx, x, weight, running_means, running_vars, groups, eps, update):
        out, z, stats = split_stride2_train_fwd_op(x, weight, list(running_means),
                                                   list(running_vars), groups, eps, update)
        ctx.save_for_backward(x, weight, z, stats)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, dout):
        x, weight, z, stats = ctx.saved_tensors
        dx, dweight = _split_stride2_train_backward(x, weight, z, stats, ctx.groups, dout)
        return dx, dweight, None, None, None, None, None


def split_stride2_train(x: torch.Tensor, weight: torch.Tensor,
                        running_means: Sequence[torch.Tensor],
                        running_vars: Sequence[torch.Tensor], groups: int = 1,
                        eps: float = ops.BN_EPSILON) -> torch.Tensor:
    """Stride-2 Res2Net split stage in training, K11 / K11b on CUDA:

        y_i = relu(BN_g(conv3x3_stride2(pad(x_i))))       i < s-1
        y_{s-1} = avg_pool3x3_stride2(pad(x_{s-1}))       the pads counted

    BN_g: statistics per batch group (``groups``, the model's bn_groups)
    over the output's positions, the running statistics (s-1 float32 (w,)
    tensors) updated in place unless inside ``ops.running_update(False)``.
    x: (B, s*w, T, F) channels_last; weight: (w*(s-1), w, 3, 3) OIHW in x's
    dtype. Returns (B, s*w, (T-1)//2 + 1, (F-1)//2 + 1) channels_last.
    Differentiable in x and the weight.

    Inside a step whose mesh has data ranks, ``groups`` counts the global
    batch's groups (as ``ops.bn_train``): groups inside each rank run here
    as ``groups / ranks``; groups that span ranks take the ``"span"`` route.
    A CPU tensor takes the plain version; a CUDA one launches the kernels or
    raises."""
    s = len(running_means) + 1
    b, c, t, f = x.shape
    w = c // s
    if c != s * w or weight.shape != (w * (s - 1), w, 3, 3):
        raise ValueError(f"split_stride2_train: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} do not make {s} groups of 3x3")
    update = ops.running_update_enabled()
    mesh = active_mesh()
    if mesh is not None and mesh.num_data > 1:
        if groups % mesh.num_data:
            _STRIDE2_ROUTES["span"] += 1
            return _split_stride2_span(x, weight, running_means, running_vars, groups, eps)
        groups //= mesh.num_data  # every group inside this rank
    if b % groups:
        raise ValueError(f"batch {b} not divisible into {groups} BN groups")
    if x.device.type == "cpu":
        _STRIDE2_ROUTES["train_plain"] += 1
        return split_stride2_train_reference(x, weight, running_means, running_vars, groups, eps,
                                             update)
    check_cuda("split_stride2_train", x, (torch.float32, torch.bfloat16), 4, CHANNELS_LAST)
    if weight.dtype != x.dtype or weight.device != x.device:
        raise KernelError("split_stride2_train: weight must match x's dtype and device")
    for st in (*running_means, *running_vars):
        check_cuda("split_stride2_train stats", st, (torch.float32,), 1)
        if st.shape[0] != w:
            raise KernelError(f"split_stride2_train: BN stats of {st.shape[0]} channels, "
                              f"width {w}")
    if x.numel() == 0:
        raise KernelError("split_stride2_train: empty batch")
    _STRIDE2_ROUTES["train_kernels"] += 1
    return _SplitStride2TrainFn.apply(ops.aligned_operand(x), weight, tuple(running_means),
                                      tuple(running_vars), groups, eps, update)


class Res2NetSplitConv(nn.Module):
    """Hierarchical split-s 3x3 conv stage. ``weight`` is the shared
    [3, 3, w, w*(s-1)] JAX kernel in OIHW, one block of w output rows per
    group; ``bn{i}`` holds group i's running statistics."""

    def __init__(self, split: int, width: int, strides: int = 1):
        super().__init__()
        if strides not in (1, 2):
            raise ValueError(f"split stage strides {strides}: the Res2Nets take 1 or 2")
        self.split, self.width, self.strides = split, width, strides
        self.weight = nn.Parameter(torch.empty(width * (split - 1), width, 3, 3))
        for i in range(split - 1):
            setattr(self, f"bn{i}", ops.BatchNorm(width))

    def _bns(self):
        return [getattr(self, f"bn{i}") for i in range(self.split - 1)]

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        s, w = self.split, self.width
        if x.shape[1] != s * w:
            raise ValueError(f"split stage takes {s * w} channels, got {x.shape[1]}")
        weight = self.weight.to(x.dtype)
        bns = self._bns()
        means, variances = [bn.running_mean for bn in bns], [bn.running_var for bn in bns]
        if self.strides == 1:
            if training:
                return split_chain_train(x, weight, means, variances, bns[0].groups, mask,
                                         bns[0].eps)
            return split_chain(x, weight, means, variances, mask, bns[0].eps)
        if training:
            return split_stride2_train(x, weight, means, variances, bns[0].groups, bns[0].eps)
        return split_stride2(x, weight, means, variances, bns[0].eps)


class BottleneckBlockV1(nn.Module):
    """Res2Net bottleneck v1: 1x1 conv -> BN -> relu -> split stage -> 1x1
    conv -> BN, + shortcut (1x1 strided conv + BN when projecting), relu.

    ``out_mask``, when given, is the output-resolution mask applied in the
    last BN's epilogue (the JAX model applies it after the block)."""

    def __init__(self, in_channels: int, filters: int, strides: int,
                 use_projection: bool, split: int, width: int):
        super().__init__()
        filters_out = filters * 4
        self.use_projection = use_projection
        if use_projection:
            self.proj_conv = ops.ConvFixedPadding(in_channels, filters_out, 1, strides)
            self.proj_bn = ops.BatchNorm(filters_out)
        self.conv1 = ops.ConvFixedPadding(in_channels, split * width, 1, 1)
        self.bn1 = ops.BatchNorm(split * width)
        self.split_conv = Res2NetSplitConv(split, width, strides)
        self.conv3 = ops.ConvFixedPadding(split * width, filters_out, 1, 1)
        self.bn3 = ops.BatchNorm(filters_out)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None,
                out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        shortcut = self.proj_conv(x) if self.use_projection else x
        y = self.conv1(x)
        # re-zero pad frames before the 3x3 stage (BN shifts zeros off zero)
        y = self.bn1(y, training, relu=True, mask=mask)
        y = self.split_conv(y, training, mask)
        y = self.conv3(y)
        return self.bn3(y, training, relu=True, shortcut=shortcut,
                        shortcut_bn=self.proj_bn if self.use_projection else None,
                        mask=out_mask)


# Rematerialization policies, by their jax.checkpoint_policies names: None
# and "nothing_saveable" recompute the whole block (K9 and K11 run again,
# with the running update off); "dots_saveable" and "checkpoint_dots" keep
# the outputs of the convolutions and matmuls (JAX's dots_saveable keeps
# dot_general and conv_general_dilated outputs) and recompute the rest --
# of the split stages in training, K9's and K11's operators: their conv
# outputs z_i with their statistics and the stage's output, so neither runs
# again;
# "everything_saveable" keeps everything, i.e. no remat.
REMAT_POLICIES = ("nothing_saveable", "dots_saveable", "checkpoint_dots",
                  "everything_saveable")
_SAVED_BY_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                  torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
                  torch.ops.vsv_torch.split_train_fwd.default,
                  torch.ops.vsv_torch.split_stride2_train_fwd.default)


def remat_context(policy: Optional[str]):
    """``torch.utils.checkpoint``'s ``context_fn`` for a policy name (None for
    a plain checkpoint); raises on a name the port does not take."""
    if policy not in (None, *REMAT_POLICIES):
        raise ValueError(f"remat_policy {policy!r} is not ported; the port takes "
                         f"{REMAT_POLICIES}")
    if policy in ("dots_saveable", "checkpoint_dots"):
        return functools.partial(create_selective_checkpoint_contexts, list(_SAVED_BY_DOTS))
    return None


def remat_call(fn, *inputs: torch.Tensor, context_fn=None):
    """``fn(*inputs)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are freed after the forward and recomputed in the backward.
    The first call updates the BN running statistics; the recompute runs
    with ``ops.running_update(False)``, so K5 and its plain version leave
    them alone and the recomputed activations equal the first ones (K5
    reruns bit for bit). ``fn`` may return a tensor or a tuple of them."""
    calls = 0

    def run(*args):
        nonlocal calls
        first = calls == 0
        calls += 1
        with ops.running_update(first):
            return fn(*args)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, *inputs, use_reentrant=False, preserve_rng_state=False, **kw)


def remat_block(block: nn.Module, x: torch.Tensor, training: bool,
                mask: Optional[torch.Tensor], out_mask: Optional[torch.Tensor],
                context_fn=None) -> torch.Tensor:
    """``block(x, training, mask, out_mask)`` under :func:`remat_call`, one
    checkpoint per block as the JAX package's ``nn.remat`` of
    ``BottleneckBlockV1``."""
    return remat_call(lambda inp: block(inp, training, mask, out_mask), x,
                      context_fn=context_fn)


@dataclasses.dataclass(frozen=True)
class Res2NetConfig:
    """Static architecture config (same fields as the JAX package's)."""

    name: str
    num_filters: Tuple[int, ...] = (32, 64, 128, 256)
    block_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    block_strides: Tuple[int, ...] = (1, 2, 2, 2)
    width: Tuple[int, ...] = (24, 48, 96, 192)
    split: int = 4
    output_dim: int = 256
    kernel_size: int = 3
    conv_stride: int = 1
    pool: str = "stats"  # "stats" | "att_stats"


def _strided(n: int, s: int) -> int:
    """Output length of a fixed-padded conv at stride s."""
    return (n - 1) // s + 1


class Res2Net(nn.Module):
    """Res2Net embedding model: (B, T, F) features -> (B, output_dim).

    ``dtype`` is the compute dtype (None keeps the input's, bfloat16 for a
    bf16 model); parameters stay float32. ``feat_dim`` fixes the head's dense
    width, which the JAX package infers from the first input.

    ``remat`` checkpoints every bottleneck block in training
    (:func:`remat_block`); ``remat_stages`` (0-based) limits it to those
    stages, ``remat_keep_blocks`` keeps the (stage, block) pairs listed
    resident, and ``remat_policy`` names what a checkpoint keeps
    (:data:`REMAT_POLICIES`)."""

    def __init__(self, config: Res2NetConfig, feat_dim: int = 80,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 remat_policy: Optional[str] = None,
                 remat_stages: Optional[Sequence[int]] = None,
                 remat_keep_blocks: Optional[Sequence[Tuple[int, int]]] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.remat_context = remat_context(remat_policy)
        keep = frozenset(tuple(p) for p in (remat_keep_blocks or ()))
        stages = None if remat_stages is None else frozenset(remat_stages)
        remat = remat and remat_policy != "everything_saveable"
        self.initial_conv = ops.ConvFixedPadding(
            1, cfg.num_filters[0], cfg.kernel_size, cfg.conv_stride)
        self.initial_bn = ops.BatchNorm(cfg.num_filters[0])
        channels, freq = cfg.num_filters[0], _strided(feat_dim, cfg.conv_stride)
        self.blocks = []
        for i, num_blocks in enumerate(cfg.block_sizes):
            for j in range(num_blocks):
                strides = cfg.block_strides[i] if j == 0 else 1
                name = f"layer{i + 1}_block{j + 1}"
                block = BottleneckBlockV1(
                    channels, cfg.num_filters[i], strides, use_projection=(j == 0),
                    split=cfg.split, width=cfg.width[i])
                self.add_module(name, block)
                rematted = remat and (stages is None or i in stages) and (i, j) not in keep
                self.blocks.append((block, strides, rematted))
                channels = cfg.num_filters[i] * 4
                freq = _strided(freq, strides)
        self.head = ops.EmbeddingHead(channels, freq, cfg.output_dim, cfg.pool)

    def set_bn_groups(self, groups: int) -> None:
        """Training BN statistics over ``groups`` equal batch groups in every
        BN of the model (the JAX package's ``bn_groups`` context)."""
        ops.set_bn_groups(self, groups)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        if x.ndim != 3:
            raise ValueError(f"expects (B, T, F) features, got {tuple(x.shape)}")
        x = x[:, None]  # (B, 1, T, F)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.contiguous(memory_format=CHANNELS_LAST)
        x = self.initial_conv(x)
        if mask is not None:
            mask = ops.downsample_mask(mask.float(), cfg.conv_stride, x.shape[2])
        x = self.initial_bn(x, training, relu=True, mask=mask)
        checkpointing = training and torch.is_grad_enabled()
        for block, strides, rematted in self.blocks:
            out_mask = None
            if mask is not None:
                out_mask = ops.downsample_mask(mask, strides, _strided(x.shape[2], strides))
            if rematted and checkpointing:
                x = remat_block(block, x, training, mask, out_mask, self.remat_context)
            else:
                x = block(x, training, mask, out_mask)
            mask = out_mask
        return self.head(x, training, mask)


RES2NET_CONFIGS = {
    "res2net50_w24_s4_c64": Res2NetConfig(
        name="res2net50_w24_s4_c64", num_filters=(64, 128, 256, 512)),
    "res2net50_w24_s4_c32": Res2NetConfig(
        name="res2net50_w24_s4_c32", num_filters=(32, 64, 128, 256)),
    "res2net50_w8_s6_c16": Res2NetConfig(
        name="res2net50_w8_s6_c16", num_filters=(16, 32, 64, 128),
        width=(8, 16, 32, 64), split=6, output_dim=192),
    "res2net101_w24_s4_c32_att": Res2NetConfig(
        name="res2net101_w24_s4_c32_att", num_filters=(32, 64, 128, 256),
        block_sizes=(3, 4, 23, 3), pool="att_stats"),
    "res2net152_w24_s4_c32_att": Res2NetConfig(
        name="res2net152_w24_s4_c32_att", num_filters=(32, 64, 128, 256),
        block_sizes=(3, 8, 36, 3), pool="att_stats"),
    "res2net200_w24_s4_c32_att": Res2NetConfig(
        name="res2net200_w24_s4_c32_att", num_filters=(32, 64, 128, 256),
        block_sizes=(3, 24, 36, 3), pool="att_stats"),
}


def register_res2net_variant(name: str, **kwargs) -> str:
    """Register ``name`` -> Res2NetConfig(name=name, **kwargs) for get_model()."""
    RES2NET_CONFIGS[name] = Res2NetConfig(name=name, **kwargs)
    return name

