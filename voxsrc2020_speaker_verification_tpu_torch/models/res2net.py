"""Res2Net speaker embedding models, eval and training mode.

Same architecture, names and configs as the JAX package's
``models/res2net.py``: a 3x3 stem, Res2Net bottleneck-v1 blocks in four
stages with strides (1, 2, 2, 2), and a stats-pool embedding head.

The stride-1 split stage is K2 (``csrc/split_conv.cu``, wrapped by
:func:`split_chain`): one launch per group fuses the masked hierarchical add,
the 3x3 conv, eval BN and relu. The stride-2 split stage is one grouped conv
(``F.conv2d(groups=s-1)``) followed by K3 and the 3x3 average pool of the
last group.

Training mode follows the JAX package's autodiff path: the stride-1 chain
is, per group, ``F.conv2d`` -> K5 (training BN + relu, ``ops.bn_train``) ->
the add into the next group; the stride-2 stage is one grouped conv, one K5
launch over all s-1 groups (statistics are per channel, so this is exact)
and the average-pool tail. K2 stays the eval path, since its BN uses running
statistics.

Rematerialization (``remat``, ``remat_stages``, ``remat_keep_blocks``,
``remat_policy``, the JAX package's options) checkpoints whole bottleneck
blocks in training: the block's activations are dropped after the forward
and recomputed in the backward (:func:`remat_block`). The recomputed
forward runs K5 again without its running-statistics update, so the
statistics are updated once, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..kernels import SPLIT_CONV, KernelError, check_cuda, dtype_code, num_sms, ptr
from ..ops import nn as ops

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


class Res2NetSplitConv(nn.Module):
    """Hierarchical split-s 3x3 conv stage. ``weight`` is the shared
    [3, 3, w, w*(s-1)] JAX kernel in OIHW, one block of w output rows per
    group; ``bn{i}`` holds group i's running statistics."""

    def __init__(self, split: int, width: int, strides: int = 1):
        super().__init__()
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
        if self.strides == 1:
            if training:
                return self._train_chain(x, weight, bns, mask)
            return split_chain(x, weight, [bn.running_mean for bn in bns],
                               [bn.running_var for bn in bns], mask, bns[0].eps)
        # stride > 1: no hierarchical adds, so the s-1 convs are one grouped
        # conv; BN + relu of all groups is one K3 (eval) or K5 (training) pass
        xp = ops.fixed_padding(x, 3)
        y = F.conv2d(xp[:, : w * (s - 1)], weight, stride=self.strides,
                     groups=s - 1).contiguous(memory_format=CHANNELS_LAST)
        mean = torch.cat([bn.running_mean for bn in bns])
        var = torch.cat([bn.running_var for bn in bns])
        if training:
            y = ops.bn_train(y, mean, var, groups=bns[0].groups, relu=True,
                             eps=bns[0].eps)
            if ops.running_update_enabled():
                with torch.no_grad():  # the update ran on the concatenated copy
                    for i, bn in enumerate(bns):
                        bn.running_mean.copy_(mean[i * w: (i + 1) * w])
                        bn.running_var.copy_(var[i * w: (i + 1) * w])
        else:
            y = ops.bn_act(y, mean, var, relu=True, eps=bns[0].eps)
        tail = ops.avg_pool_3x3(xp[:, w * (s - 1):], self.strides)
        return torch.cat([y, tail], dim=1).contiguous(memory_format=CHANNELS_LAST)

    def _train_chain(self, x, weight, bns, mask):
        """Stride-1 chain in training mode, step for step as the JAX
        package's (models/res2net.py:82-107)."""
        w = self.width
        groups = torch.split(x, w, dim=1)
        outputs = []
        for i, bn in enumerate(bns):
            inp = groups[i] if i == 0 else groups[i] + ops.mask_time(outputs[-1], mask)
            y = F.conv2d(inp, weight[i * w: (i + 1) * w], padding=1)
            outputs.append(bn(y, True, relu=True))
        outputs.append(groups[-1])
        return torch.cat(outputs, dim=1).contiguous(memory_format=CHANNELS_LAST)


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
# and "nothing_saveable" recompute the whole block; "dots_saveable" and
# "checkpoint_dots" keep the outputs of the convolutions and matmuls (JAX's
# dots_saveable keeps dot_general and conv_general_dilated outputs) and
# recompute the rest; "everything_saveable" keeps everything, i.e. no remat.
REMAT_POLICIES = ("nothing_saveable", "dots_saveable", "checkpoint_dots",
                  "everything_saveable")
_SAVED_BY_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                  torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


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

