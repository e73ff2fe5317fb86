"""NN primitives of the Res2Net serving path, eval mode.

Activations are NCHW tensors in ``torch.channels_last`` memory, i.e.
physically (B, T, F, C) like the JAX package's NHWC: H is time, W is
frequency. Parameters are float32; the compute dtype is the activation's.

Two of these primitives are CUDA kernels with a plain PyTorch version beside
them:

* :func:`bn_act` -- K3 (``csrc/bn_epilogue.cu``): eval batch norm with its
  optional shortcut add, relu and time mask in one pass;
* :func:`stats_pool` -- K4 (``csrc/stats_pool.cu``): masked mean ||
  sqrt(var + eps) over time.

A wrapper takes the plain version only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import BN_ACT, STATS_POOL, KernelError, check_cuda, dtype_code, ptr

BN_EPSILON = 1e-5
POOL_EPSILON = 1e-5
CHANNELS_LAST = torch.channels_last
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _pad_amounts(kernel_size) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    kh, kw = _pair(kernel_size)
    ph, pw = kh - 1, kw - 1
    return (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def fixed_padding(x: torch.Tensor, kernel_size) -> torch.Tensor:
    """Explicit (k-1)//2 / rest zero padding of time and frequency (none for
    a 1x1 kernel, which then returns x itself)."""
    (hb, he), (wb, we) = _pad_amounts(kernel_size)
    if hb == he == wb == we == 0:
        return x
    return F.pad(x, (wb, we, hb, he)).contiguous(memory_format=CHANNELS_LAST)


class Conv2d(nn.Module):
    """Bias-free conv; ``weight`` is OIHW (the JAX HWIO kernel transposed
    (3, 2, 0, 1)). ``padding`` is ``"SAME"`` (stride 1, odd kernel) or
    ``"VALID"``. Computed in the input's dtype."""

    def __init__(self, in_channels: int, features: int, kernel_size=1,
                 strides=1, padding: str = "SAME"):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        if padding == "SAME":
            if self.strides != (1, 1) or any(k % 2 == 0 for k in self.kernel_size):
                raise ValueError("SAME padding is ported for stride 1, odd kernels")
            self.padding = tuple(k // 2 for k in self.kernel_size)
        elif padding == "VALID":
            self.padding = (0, 0)
        else:
            raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.strides,
                     padding=self.padding)
        return y.contiguous(memory_format=CHANNELS_LAST)


class ConvFixedPadding(nn.Module):
    """Stride 1: SAME conv. Stride > 1: :func:`fixed_padding`, then VALID, so
    output j is anchored at input stride*j on both axes."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides=1):
        super().__init__()
        self.kernel_size = kernel_size
        self.strided = any(s > 1 for s in _pair(strides))
        self.conv2d = Conv2d(in_channels, features, kernel_size, strides,
                             "VALID" if self.strided else "SAME")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.strided:
            x = fixed_padding(x, self.kernel_size)
        return self.conv2d(x)


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) in float32, cast to x's dtype."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x.float() - mean.view(shape)) * torch.rsqrt(var.view(shape) + eps)
    return y.to(x.dtype)


def mask_time(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the invalid time positions of an NCHW tensor; ``mask`` is a
    (B, T') 0/1 validity mask with T' >= T."""
    if mask is None:
        return x
    m = mask[:, : x.shape[2]].to(x.dtype)
    return x * m[:, None, :, None]


def downsample_mask(mask: Optional[torch.Tensor], strides: int,
                    t_out: int) -> Optional[torch.Tensor]:
    """Track a (B, T) mask through a stride-``s`` conv: output j is anchored
    at input s*j, so keep every s-th flag."""
    if mask is None or strides == 1:
        return None if mask is None else mask[:, :t_out]
    return mask[:, ::strides][:, :t_out]


def bn_act_reference(x, mean, var, *, relu=False, shortcut=None,
                     shortcut_mean=None, shortcut_var=None, mask=None,
                     eps=BN_EPSILON) -> torch.Tensor:
    """Plain version of :func:`bn_act`, rounding where the JAX package rounds:
    each normalized term is cast to the dtype before the add."""
    y = _normalize(x, mean, var, eps)
    if shortcut is not None:
        if shortcut_mean is not None:
            shortcut = _normalize(shortcut, shortcut_mean, shortcut_var, eps)
        y = y + shortcut
    if relu:
        y = torch.relu(y)
    y = mask_time(y, mask)
    return y.contiguous(memory_format=CHANNELS_LAST)


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, *,
           relu: bool = False, shortcut: Optional[torch.Tensor] = None,
           shortcut_mean: Optional[torch.Tensor] = None,
           shortcut_var: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None,
           eps: float = BN_EPSILON) -> torch.Tensor:
    """Eval batch norm with its epilogue, K3 on CUDA:

        y = relu?((x - mean) * rsqrt(var + eps)
                  [+ (s - mean_s) * rsqrt(var_s + eps)  or  + s]) * mask?

    x, shortcut: (B, C, T, F) channels_last; mean, var: (C,) float32 running
    statistics; mask: (B, T') float 0/1 with T' >= T.
    """
    if shortcut is not None and shortcut.shape != x.shape:
        raise ValueError(f"shortcut {tuple(shortcut.shape)} != x {tuple(x.shape)}")
    if (shortcut_mean is None) != (shortcut_var is None) or (
            shortcut_mean is not None and shortcut is None):
        raise ValueError("shortcut_mean/var come together, with a shortcut")
    if x.device.type == "cpu":
        return bn_act_reference(
            x, mean, var, relu=relu, shortcut=shortcut,
            shortcut_mean=shortcut_mean, shortcut_var=shortcut_var,
            mask=mask, eps=eps)

    check_cuda("bn_act", x, _KERNEL_DTYPES, 4, CHANNELS_LAST)
    b, c, t, f = x.shape
    if c % 4:
        raise KernelError(f"bn_act: channels must be a multiple of 4, got {c}")
    for name, s in (("mean", mean), ("var", var), ("shortcut_mean", shortcut_mean),
                    ("shortcut_var", shortcut_var)):
        if s is not None:
            check_cuda(f"bn_act {name}", s, (torch.float32,), 1)
            if s.shape[0] != c:
                raise KernelError(f"bn_act: {name} has {s.shape[0]} channels, x {c}")
    if shortcut is not None:
        check_cuda("bn_act shortcut", shortcut, (x.dtype,), 4, CHANNELS_LAST)
    m = None
    if mask is not None:
        m = mask[:, :t].float().contiguous()
        if m.shape != (b, t) or m.device != x.device:
            raise KernelError(f"bn_act: mask {tuple(mask.shape)} does not cover (B, T)=({b}, {t})")
    sc_mode = 0 if shortcut is None else (2 if shortcut_mean is not None else 1)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    BN_ACT.launch(
        "bn_act", x.device, dtype_code(x.dtype), ptr(x), ptr(mean), ptr(var),
        ptr(shortcut), ptr(shortcut_mean), ptr(shortcut_var), ptr(m), ptr(out),
        x.numel(), c, f, int(relu), sc_mode, eps, sms)
    return out


class BatchNorm(nn.Module):
    """Affine-free batch norm, eps 1e-5, eval mode only: normalizes with the
    ``running_mean``/``running_var`` buffers. On 4-D activations it runs
    through :func:`bn_act` with its epilogue flags; on the 2-D head inputs it
    is a plain float32 normalize cast to the input dtype."""

    def __init__(self, num_features: int, eps: float = BN_EPSILON):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, training: bool = False, *,
                relu: bool = False, shortcut: Optional[torch.Tensor] = None,
                shortcut_bn: Optional["BatchNorm"] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if training:
            raise NotImplementedError(
                "training-mode BN is not ported yet (ROADMAP.md, slice 2)")
        if x.ndim == 2:
            if relu or shortcut is not None or mask is not None:
                raise ValueError("the 2-D head BN takes no epilogue")
            return _normalize(x, self.running_mean, self.running_var, self.eps)
        return bn_act(
            x, self.running_mean, self.running_var, relu=relu, shortcut=shortcut,
            shortcut_mean=None if shortcut_bn is None else shortcut_bn.running_mean,
            shortcut_var=None if shortcut_bn is None else shortcut_bn.running_var,
            mask=mask, eps=self.eps)


class Dense(nn.Module):
    """Bias-free dense; ``weight`` is (out, in), the JAX (in, out) kernel
    transposed."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype))


def stats_pool_reference(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`stats_pool`: float32 two-pass moments."""
    x32 = x.float()
    if mask is None:
        mean = x32.mean(dim=2, keepdim=True)
        var = torch.square(x32 - mean).mean(dim=2, keepdim=True)
    else:
        m = mask[:, : x.shape[2]].float()[:, None, :, None]
        denom = torch.clamp(m.sum(dim=2, keepdim=True), min=1.0)
        mean = (x32 * m).sum(dim=2, keepdim=True) / denom
        var = (torch.square(x32 - mean) * m).sum(dim=2, keepdim=True) / denom
    out = torch.cat([mean, torch.sqrt(var + POOL_EPSILON)], dim=1)
    return out.to(x.dtype).contiguous(memory_format=CHANNELS_LAST)


def stats_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Statistics pooling over time, K4 on CUDA: (B, C, T, W) channels_last
    -> (B, 2C, 1, W) channels_last, i.e. JAX's NHWC (B, 1, W, 2C). Moments
    are float32 with denominator max(sum(mask), 1); the output is cast to
    x's dtype."""
    if x.device.type == "cpu":
        return stats_pool_reference(x, mask)
    check_cuda("stats_pool", x, _KERNEL_DTYPES, 4, CHANNELS_LAST)
    b, c, t, w = x.shape
    m = None
    if mask is not None:
        m = mask[:, :t].float().contiguous()
        if m.shape != (b, t) or m.device != x.device:
            raise KernelError(f"stats_pool: mask {tuple(mask.shape)} does not cover (B, T)=({b}, {t})")
    out = torch.empty((b, 2 * c, 1, w), dtype=x.dtype, device=x.device,
                      memory_format=CHANNELS_LAST)
    if out.numel() == 0:
        return out
    STATS_POOL.launch("stats_pool", x.device, dtype_code(x.dtype), ptr(x),
                      ptr(m), ptr(out), b, t, w, c, POOL_EPSILON)
    return out


class EmbeddingHead(nn.Module):
    """Stats pool -> flatten in NHWC order (W, 2C) -> BN -> dense -> BN.

    The flatten keeps the downsampled frequency axis, so the dense input is
    freq_out * 2 * channels, in the JAX package's order."""

    def __init__(self, channels: int, freq: int, output_dim: int,
                 pool: str = "stats"):
        super().__init__()
        if pool != "stats":
            raise NotImplementedError(
                f"pool {pool!r} is not ported yet (ROADMAP.md); only 'stats'")
        in_features = freq * 2 * channels
        self.pre_bn = BatchNorm(in_features)
        self.embedding = Dense(in_features, output_dim)
        self.post_bn = BatchNorm(output_dim)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = stats_pool(x, mask)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.pre_bn(x, training)
        x = self.embedding(x)
        return self.post_bn(x, training)


def avg_pool_3x3(x: torch.Tensor, strides: int) -> torch.Tensor:
    """3x3 VALID average pool over an already fixed-padded input; the pads
    are zeros included in the mean. Nine strided-slice adds, in the JAX
    package's order, so bf16 rounds at the same points."""
    _, _, h, w = x.shape
    oh = (h - 3) // strides + 1
    ow = (w - 3) // strides + 1
    total = None
    for di in range(3):
        for dj in range(3):
            piece = x[:, :, di: di + (oh - 1) * strides + 1: strides,
                      dj: dj + (ow - 1) * strides + 1: strides]
            total = piece if total is None else total + piece
    return (total / torch.tensor(9.0, dtype=x.dtype)).contiguous(
        memory_format=CHANNELS_LAST)
