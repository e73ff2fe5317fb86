"""Dual Path Network (DPN) speaker embedding model, eval and training mode.

Same architecture, names and configs as the JAX package's ``models/dpn.py``:
a 3x3 stem (10 channels for dpn68) -> BN -> relu, four stages of dual-path
blocks (pre-activation BN -> relu -> conv layers 1x1 -> 3x3 with cardinality
32 and the stage's stride -> 1x1; the first ``bw`` output channels add to a
residual path, the rest extend a densely concatenated path; the first block
of a stage projects the shortcut), then concat -> BN -> relu -> the stats-pool
embedding head.

Every BN is K3 (eval) or K5 (training) with its relu in the epilogue and,
before the 3x3 conv, the time mask; the stem's and the first block's BNs run
at 10 channels, on the kernels' single-channel paths. The strided convs use
XLA's SAME padding (asymmetric at even lengths, ``ops.same_pads``).
Rematerialization (the JAX package's ``remat``, ``remat_stages``,
``remat_keep_blocks``, ``remat_policy``) checkpoints whole dual-path blocks,
as ``models/res2net.py`` does bottleneck blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops import nn as ops
from .res2net import remat_call, remat_context

CHANNELS_LAST = torch.channels_last
State = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class BnReluConv(nn.Module):
    """Pre-activation conv: BN -> relu (-> time mask) -> conv, SAME padding."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, strides: int = 1,
                 cardinality: int = 1):
        super().__init__()
        self.bn = ops.BatchNorm(in_channels)
        self.conv2d = ops.Conv2d(in_channels, features, kernel_size, strides, "SAME",
                                 cardinality=cardinality)

    def forward(self, x: torch.Tensor, training: bool,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the mask is passed for the 3x3 conv only: it re-zeroes pad frames
        # after the BN so that they cannot enter the receptive field
        return self.conv2d(self.bn(x, training, relu=True, mask=mask))


class DualPathBlock(nn.Module):
    """One dual-path block; ``projection_type`` is ``"projected"`` (stride
    1), ``"downsampled"`` (stride 2) or ``"normal"``."""

    def __init__(self, in_channels: int, num_1_a: int, num_3_b: int, num_1_c: int, inc: int,
                 projection_type: str, cardinality: int = 32, use_se: bool = False):
        super().__init__()
        if projection_type not in ("projected", "downsampled", "normal"):
            raise ValueError(f"unknown projection type {projection_type!r}")
        strides = 2 if projection_type == "downsampled" else 1
        self.num_1_c = num_1_c
        if projection_type != "normal":
            self.proj = BnReluConv(in_channels, num_1_c + 2 * inc, 1, strides)
        self.conv_a = BnReluConv(in_channels, num_1_a, 1)
        self.conv_b = BnReluConv(num_1_a, num_3_b, 3, strides, cardinality)
        if use_se:
            self.se = ops.SqueezeExcitation(num_3_b, ratio=8)
        self.conv_c = BnReluConv(num_3_b, num_1_c + inc, 1)

    def forward(self, inputs: State, training: bool,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(inputs, tuple):
            res_in, dense_in = inputs
            x = torch.cat([res_in, dense_in], dim=1).contiguous(memory_format=CHANNELS_LAST)
        else:
            res_in = dense_in = None
            x = inputs
        if hasattr(self, "proj"):
            projected = self.proj(x, training)
            res_in, dense_in = projected[:, : self.num_1_c], projected[:, self.num_1_c:]
        y = self.conv_a(x, training)
        y = self.conv_b(y, training, mask)
        if hasattr(self, "se"):
            y = self.se(y)
        y = self.conv_c(y, training)
        res_out, dense_out = y[:, : self.num_1_c], y[:, self.num_1_c:]
        return ((res_in + res_out).contiguous(memory_format=CHANNELS_LAST),
                torch.cat([dense_in, dense_out], dim=1).contiguous(memory_format=CHANNELS_LAST))


@dataclasses.dataclass(frozen=True)
class DpnConfig:
    """Static architecture config (same fields as the JAX package's)."""

    name: str
    output_dim: int = 256
    num_init_features: int = 10
    kernel_size: int = 3
    conv_stride: int = 1
    projection_types: Tuple[str, ...] = ("projected", "downsampled", "downsampled", "downsampled")
    bw: int = 64
    k_r: int = 128
    cardinality: int = 32
    k_sec: Tuple[int, ...] = (3, 4, 12, 3)
    inc_sec: Tuple[int, ...] = (16, 32, 32, 64)
    bw_factor: int = 1
    use_se: bool = False
    pool: str = "stats"


def _same_out(n: int, s: int) -> int:
    return -(-n // s)


class Dpn(nn.Module):
    """DPN embedding model: (B, T, F) features -> (B, output_dim).

    ``dtype`` is the compute dtype (None keeps the input's); parameters stay
    float32. ``feat_dim`` fixes the head's dense width. ``remat*`` as in
    :class:`models.res2net.Res2Net`, per dual-path block."""

    def __init__(self, config: DpnConfig, feat_dim: int = 80,
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
        self.initial_conv = ops.Conv2d(1, cfg.num_init_features, cfg.kernel_size,
                                       cfg.conv_stride, "SAME")
        self.initial_bn = ops.BatchNorm(cfg.num_init_features)
        freq = _same_out(feat_dim, cfg.conv_stride)
        channels, res, dense = cfg.num_init_features, 0, 0
        self.blocks = []
        for i in range(4):
            bw = int(cfg.bw * (2 ** i) * cfg.bw_factor)
            inc = cfg.inc_sec[i]
            r = cfg.k_r * bw // (cfg.bw * cfg.bw_factor)
            for j in range(cfg.k_sec[i]):
                ptype = cfg.projection_types[i] if j == 0 else "normal"
                block = DualPathBlock(channels, r, r, bw, inc, ptype, cfg.cardinality,
                                      cfg.use_se)
                self.add_module(f"stage{i + 1}_block{j + 1}", block)
                strides = 2 if ptype == "downsampled" else 1
                rematted = remat and (stages is None or i in stages) and (i, j) not in keep
                self.blocks.append((block, strides, rematted))
                if ptype != "normal":
                    res, dense = bw, 2 * inc
                res, dense = bw, dense + inc
                channels = res + dense
                freq = _same_out(freq, strides)
        self.final_bn = ops.BatchNorm(channels)
        self.head = ops.EmbeddingHead(channels, freq, cfg.output_dim, cfg.pool)

    def set_bn_groups(self, groups: int) -> None:
        """Training BN statistics over ``groups`` equal batch groups."""
        ops.set_bn_groups(self, groups)

    def _block(self, block, state: State, training: bool, mask, rematted: bool) -> State:
        if not (rematted and training and torch.is_grad_enabled()):
            return block(state, training, mask)
        inputs = state if isinstance(state, tuple) else (state,)
        return remat_call(
            lambda *a: block(a if len(a) == 2 else a[0], training, mask), *inputs,
            context_fn=self.remat_context)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"expects (B, T, F) features, got {tuple(x.shape)}")
        x = x[:, None]  # (B, 1, T, F)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.initial_conv(x.contiguous(memory_format=CHANNELS_LAST))
        if mask is not None:
            mask = mask.float()
        x = self.initial_bn(x, training, relu=True, mask=mask)
        state: State = x
        for block, strides, rematted in self.blocks:
            state = self._block(block, state, training, mask, rematted)
            if mask is not None:
                mask = ops.downsample_mask(mask, strides, state[0].shape[2])
                state = tuple(ops.mask_time(s, mask) for s in state)
        x = torch.cat(list(state), dim=1).contiguous(memory_format=CHANNELS_LAST)
        x = self.final_bn(x, training, relu=True)
        return self.head(x, training, mask)


DPN_CONFIGS = {
    "dpn68": DpnConfig(name="dpn68"),
}
