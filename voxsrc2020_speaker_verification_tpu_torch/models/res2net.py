"""Res2Net speaker embedding models, eval mode.

Same architecture, names and configs as the JAX package's
``models/res2net.py``: a 3x3 stem, Res2Net bottleneck-v1 blocks in four
stages with strides (1, 2, 2, 2), and a stats-pool embedding head.

The stride-1 split stage is K2 (``csrc/split_conv.cu``, wrapped by
:func:`split_chain`): one launch per group fuses the masked hierarchical add,
the 3x3 conv, eval BN and relu. The stride-2 split stage is one grouped conv
(``F.conv2d(groups=s-1)``) followed by K3 and the 3x3 average pool of the
last group.

Training mode is not ported yet: ``training=True`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import SPLIT_CONV, KernelError, check_cuda, dtype_code, ptr
from ..ops import nn as ops

CHANNELS_LAST = torch.channels_last
_SPLIT_TN = (12, 8, 6, 4, 3, 2, 1)  # output channels per thread in K2


def _no_training(training: bool) -> None:
    if training:
        raise NotImplementedError(
            "training mode is not ported yet (ROADMAP.md, slice 2)")


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
    One launch per group writes y_i into its channel slice of the output.
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
    # bf16 at widths of 8k runs on the tensor cores, with the weights as
    # (w*(s-1), 9*w) rows (tap-major, then input channel); otherwise the
    # CUDA-core variant reads the JAX layout (3, 3, w, w*(s-1))
    mma = x.dtype == torch.bfloat16 and w % 8 == 0 and x.data_ptr() % 16 == 0
    wk = (weight.permute(0, 2, 3, 1) if mma else weight.permute(2, 3, 1, 0)).contiguous()
    for i in range(s - 1):
        prev = ptr(out) if i > 0 else None
        shape = (b * t * f, t, f, c, i * w, c, (i - 1) * w, i * w, w,
                 (s - 1) * w, (s - 1) * w, w if i == 0 else 0, eps)
        if mma:
            SPLIT_CONV.launch("split_group_mma", x.device, tn, ptr(x), prev, ptr(m),
                              ptr(wk), i * w, ptr(means[i]), ptr(variances[i]),
                              ptr(out), b, *shape[1:])
        else:
            SPLIT_CONV.launch("split_group", x.device, dtype_code(x.dtype), tn, ptr(x),
                              prev, ptr(m), ptr(wk), w * (s - 1), i * w, ptr(means[i]),
                              ptr(variances[i]), ptr(out), *shape)
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
        _no_training(training)
        s, w = self.split, self.width
        if x.shape[1] != s * w:
            raise ValueError(f"split stage takes {s * w} channels, got {x.shape[1]}")
        weight = self.weight.to(x.dtype)
        bns = self._bns()
        if self.strides == 1:
            return split_chain(x, weight, [bn.running_mean for bn in bns],
                               [bn.running_var for bn in bns], mask, bns[0].eps)
        # stride > 1: no hierarchical adds, so the s-1 convs are one grouped
        # conv; BN + relu of all groups is one K3 pass
        xp = ops.fixed_padding(x, 3)
        y = F.conv2d(xp[:, : w * (s - 1)], weight, stride=self.strides,
                     groups=s - 1).contiguous(memory_format=CHANNELS_LAST)
        y = ops.bn_act(y, torch.cat([bn.running_mean for bn in bns]),
                       torch.cat([bn.running_var for bn in bns]), relu=True,
                       eps=bns[0].eps)
        tail = ops.avg_pool_3x3(xp[:, w * (s - 1):], self.strides)
        return torch.cat([y, tail], dim=1).contiguous(memory_format=CHANNELS_LAST)


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
        _no_training(training)
        shortcut = self.proj_conv(x) if self.use_projection else x
        y = self.conv1(x)
        # re-zero pad frames before the 3x3 stage (BN shifts zeros off zero)
        y = self.bn1(y, relu=True, mask=mask)
        y = self.split_conv(y, training, mask)
        y = self.conv3(y)
        return self.bn3(y, relu=True, shortcut=shortcut,
                        shortcut_bn=self.proj_bn if self.use_projection else None,
                        mask=out_mask)


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
    width, which the JAX package infers from the first input."""

    def __init__(self, config: Res2NetConfig, feat_dim: int = 80,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
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
                self.blocks.append((block, strides))
                channels = cfg.num_filters[i] * 4
                freq = _strided(freq, strides)
        self.head = ops.EmbeddingHead(channels, freq, cfg.output_dim, cfg.pool)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        _no_training(training)
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
        x = self.initial_bn(x, relu=True, mask=mask)
        for block, strides in self.blocks:
            out_mask = None
            if mask is not None:
                out_mask = ops.downsample_mask(mask, strides, _strided(x.shape[2], strides))
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

