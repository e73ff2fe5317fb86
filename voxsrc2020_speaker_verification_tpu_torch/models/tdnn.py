"""TDNN (x-vector style) speaker embedding model, eval and training mode.

Same architecture, names and variants as the JAX package's
``models/tdnn.py``: five conv blocks on the time axis (filters 512, 512, 512,
512, 1536; kernels 5, 3, 3, 1, 1 frames; time dilations 1, 2, 3, 1, 1), each
conv -> act -> norm in the block ``order`` the JAX block takes, the time mask
after each block, then the stats-pool embedding head.

The input (B, T, F) becomes (B, F, T, 1) in ``torch.channels_last`` memory:
the JAX package's NHWC (B, T, 1, F) with W = 1, so each (k, 1) conv is a
dilated 1-D conv over time. BN is K3 (eval) or K5 (training); the head's
pool is K4 over T at W = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import nn as ops

CHANNELS_LAST = torch.channels_last
BLOCK_ORDERS = ("conv_relu_bn", "conv_gelu_bn", "conv_mish_bn", "conv_relu_ln",
                "conv_gelu_ln", "conv_mish_ln", "conv_bn_relu", "conv_se_relu_bn",
                "conv_relu_se_bn", "conv_bn_se_relu")


class TdnnBlock(nn.Module):
    """One conv block: a (k, 1) conv with SAME padding and time dilation,
    then the ``order``'s parts: relu | gelu | mish, bn | ln, se (squeeze
    ratio 8 right after relu, else 16). A BN followed by relu takes the relu
    in its kernel's epilogue."""

    def __init__(self, in_channels: int, filters: int, kernel_size: Tuple[int, int],
                 dilation: Tuple[int, int], cardinality: int = 1,
                 order: str = "conv_relu_bn"):
        super().__init__()
        self.parts = tuple(order.split("_")[1:])
        if order.split("_")[0] != "conv" or not set(self.parts) <= {
                "relu", "gelu", "mish", "bn", "ln", "se"}:
            raise ValueError(f"unknown block order {order!r}")
        self.conv2d = ops.Conv2d(in_channels, filters, kernel_size, 1, "SAME",
                                 dilation=dilation, cardinality=cardinality)
        if "bn" in self.parts:
            self.bn = ops.BatchNorm(filters)
        if "se" in self.parts:
            i = self.parts.index("se")
            self.se = ops.SqueezeExcitation(filters, 8 if i and self.parts[i - 1] == "relu" else 16)

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        x = self.conv2d(x)
        i = 0
        while i < len(self.parts):
            p = self.parts[i]
            if p == "bn":
                fuse = self.parts[i + 1: i + 2] == ("relu",)
                x = self.bn(x, training, relu=fuse)
                i += fuse
            elif p == "ln":
                x = ops.layer_norm(x)
            elif p == "se":
                x = self.se(x)
            else:
                x = ops.ACTIVATIONS[p](x)
            i += 1
        return x


@dataclasses.dataclass(frozen=True)
class TdnnConfig:
    """Static architecture config (the JAX ``Tdnn`` module's fields)."""

    name: str = "tdnn"
    output_dim: int = 256
    block_filters: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    block_kernel_sizes: Tuple[Tuple[int, int], ...] = ((5, 1), (3, 1), (3, 1), (1, 1), (1, 1))
    block_dilations: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 1), (3, 1), (1, 1), (1, 1))
    block_cardinalities: Optional[Tuple[int, ...]] = None
    block_order: str = "conv_relu_bn"
    pool: str = "stats"


class Tdnn(nn.Module):
    """TDNN embedding model: (B, T, F) features -> (B, output_dim).
    ``dtype`` is the compute dtype (None keeps the input's)."""

    def __init__(self, config: TdnnConfig, feat_dim: int = 40,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        channels = feat_dim
        for i, (f, k, d) in enumerate(zip(cfg.block_filters, cfg.block_kernel_sizes,
                                          cfg.block_dilations)):
            card = 1 if cfg.block_cardinalities is None else cfg.block_cardinalities[i]
            self.add_module(f"block{i + 1}", TdnnBlock(channels, f, tuple(k), tuple(d), card,
                                                       cfg.block_order))
            channels = f
        self.head = ops.EmbeddingHead(channels, 1, cfg.output_dim, cfg.pool)

    def set_bn_groups(self, groups: int) -> None:
        ops.set_bn_groups(self, groups)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"expects (B, T, F) features, got {tuple(x.shape)}")
        if self.dtype is not None:
            x = x.to(self.dtype)
        # (B, F, T, 1) channels_last: the (B, T, F) memory as it is
        x = x.transpose(1, 2)[..., None].contiguous(memory_format=CHANNELS_LAST)
        if mask is not None:
            mask = mask.float()
        for i in range(len(self.config.block_filters)):
            x = ops.mask_time(getattr(self, f"block{i + 1}")(x, training), mask)
        return self.head(x, training, mask)


# Non-recipe TDNN geometries (the JAX package's register_tdnn_variant):
# name -> Tdnn fields
TDNN_VARIANTS = {}


def register_tdnn_variant(name: str, **kwargs) -> str:
    """Register ``name`` -> TdnnConfig(name=name, **kwargs) for get_model()."""
    TDNN_VARIANTS[name] = dict(kwargs)
    return name


def tdnn_config(name: str = "tdnn") -> TdnnConfig:
    """The recipe model ``tdnn`` or a registered variant, sequences as tuples."""
    kw = {k: (tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in v)
              if isinstance(v, (list, tuple)) else v)
          for k, v in TDNN_VARIANTS.get(name, {}).items()}
    return TdnnConfig(name=name, **kw)
