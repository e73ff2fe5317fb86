"""ECAPA-TDNN speaker embedding model, eval and training mode.

Same architecture, names and configs as the JAX package's
``models/ecapa.py`` (Desplanques et al., arXiv:2005.07143, in that package's
conventions: affine-free BN, bias-free convs): a k = 5 conv -> relu -> BN
stem; three SE-Res2Blocks with time dilations 2, 3, 4 (1x1 conv -> relu ->
BN, a dilated split stage of s = 8 groups with masked hierarchical adds,
1x1 conv -> relu -> BN, masked squeeze-excitation, residual add);
multi-layer feature aggregation (concat -> 1x1 conv to 1536 -> relu);
attentive statistics pooling (``ops.AttStatsPool``, K4 and K8 at W = 1);
BN -> dense -> BN.

Layout as ``models/tdnn.py``: (B, F, T, 1) channels_last. The relu comes
before each BN, so the BNs run K3 / K5 without a relu epilogue (with the
time mask where the JAX model masks right after them). The split stage and
SE are plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import nn as ops

CHANNELS_LAST = torch.channels_last


class Conv1dReluBn(nn.Module):
    """k-tap time conv (SAME, time dilation) -> relu -> BN (-> time mask)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv2d = ops.Conv2d(in_channels, features, (kernel_size, 1), 1, "SAME",
                                 dilation=(dilation, 1))
        self.bn = ops.BatchNorm(features)

    def forward(self, x: torch.Tensor, training: bool,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.bn(torch.relu(self.conv2d(x)), training, mask=mask)


class EcapaSplitConv(nn.Module):
    """Res2Net-style hierarchical split stage with time dilation: group 0
    passes through, group i > 0 is conv_i(g_i [+ mask * y_{i-1}]) -> relu ->
    bn_i, with independent per-group (k, 1) convs."""

    def __init__(self, split: int, width: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.split, self.width = split, width
        for i in range(1, split):
            setattr(self, f"conv{i}", ops.Conv2d(width, width, (kernel_size, 1), 1, "SAME",
                                                 dilation=(dilation, 1)))
            setattr(self, f"bn{i}", ops.BatchNorm(width))

    def forward(self, x: torch.Tensor, training: bool,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.shape[1] != self.split * self.width:
            raise ValueError(f"split stage takes {self.split * self.width} channels, "
                             f"got {x.shape[1]}")
        groups = torch.split(x, self.width, dim=1)
        outputs = [groups[0]]
        for i in range(1, self.split):
            inp = groups[i]
            if i > 1:
                inp = inp + ops.mask_time(outputs[-1], mask)
            y = torch.relu(getattr(self, f"conv{i}")(inp))
            outputs.append(getattr(self, f"bn{i}")(y, training))
        return torch.cat(outputs, dim=1).contiguous(memory_format=CHANNELS_LAST)


class SERes2Block(nn.Module):
    """1x1 conv-relu-BN -> dilated split stage -> 1x1 conv-relu-BN -> SE,
    with a residual connection."""

    def __init__(self, channels: int, split: int, dilation: int, se_ratio: int = 8):
        super().__init__()
        self.conv1 = Conv1dReluBn(channels, channels, 1)
        self.split_conv = EcapaSplitConv(split, channels // split, dilation=dilation)
        self.conv3 = Conv1dReluBn(channels, channels, 1)
        self.se = ops.SqueezeExcitation(channels, se_ratio)

    def forward(self, x: torch.Tensor, training: bool,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.conv1(x, training, mask)
        y = self.split_conv(y, training, mask)
        # pad rows re-zeroed before the SE's squeeze (BN shifts them off 0)
        y = self.conv3(y, training, mask)
        return self.se(y, mask) + x


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    name: str
    channels: int = 512
    split: int = 8
    dilations: Tuple[int, ...] = (2, 3, 4)
    mfa_dim: int = 1536
    att_dim: int = 128
    output_dim: int = 192
    se_ratio: int = 8


class Ecapa(nn.Module):
    """ECAPA-TDNN: (B, T, F) features -> (B, output_dim). ``dtype`` is the
    compute dtype (None keeps the input's)."""

    def __init__(self, config: EcapaConfig, feat_dim: int = 80,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.stem = Conv1dReluBn(feat_dim, cfg.channels, 5)
        for i, d in enumerate(cfg.dilations):
            self.add_module(f"block{i + 1}", SERes2Block(cfg.channels, cfg.split, d,
                                                         cfg.se_ratio))
        self.mfa = ops.Conv2d(len(cfg.dilations) * cfg.channels, cfg.mfa_dim, 1)
        self.att_stats_pool = ops.AttStatsPool(cfg.mfa_dim, cfg.att_dim)
        self.pre_bn = ops.BatchNorm(2 * cfg.mfa_dim)
        self.embedding = ops.Dense(2 * cfg.mfa_dim, cfg.output_dim)
        self.post_bn = ops.BatchNorm(cfg.output_dim)

    def set_bn_groups(self, groups: int) -> None:
        ops.set_bn_groups(self, groups)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"expects (B, T, F) features, got {tuple(x.shape)}")
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.transpose(1, 2)[..., None].contiguous(memory_format=CHANNELS_LAST)
        if mask is not None:
            mask = mask.float()
        x = self.stem(x, training, mask)
        feats = []
        for i in range(len(self.config.dilations)):
            x = ops.mask_time(getattr(self, f"block{i + 1}")(x, training, mask), mask)
            feats.append(x)
        x = self.mfa(torch.cat(feats, dim=1))
        x = ops.mask_time(torch.relu(x), mask).contiguous(memory_format=CHANNELS_LAST)
        x = self.att_stats_pool(x, mask).reshape(x.shape[0], -1)
        x = self.pre_bn(x, training)
        return self.post_bn(self.embedding(x), training)


ECAPA_CONFIGS = {
    "ecapa_tdnn_512": EcapaConfig(name="ecapa_tdnn_512", channels=512),
    "ecapa_tdnn_1024": EcapaConfig(name="ecapa_tdnn_1024", channels=1024),
}
