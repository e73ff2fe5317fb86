"""NN primitives of the model zoo, eval and training mode.

Activations are NCHW tensors in ``torch.channels_last`` memory, i.e.
physically (B, T, F, C) like the JAX package's NHWC: H is time, W is
frequency. Parameters are float32; the compute dtype is the activation's.

Four of these primitives are CUDA kernels with a plain PyTorch version
beside them:

* :func:`bn_act` -- K3 (``csrc/bn_epilogue.cu``): eval batch norm with its
  optional shortcut add, relu and time mask in one pass;
* :func:`bn_train` -- K5 (``csrc/bn_train.cu``): training batch norm with
  statistics per batch group, the running-statistics update and K3's
  epilogue, forward and backward; across data ranks (``parallel/``), groups
  that span ranks all-reduce their sums (the spanning mode, :func:`bn_span`);
* :func:`stats_pool` -- K4 (``csrc/stats_pool.cu``): masked mean ||
  sqrt(var + eps) over time; its backward is K4b (``csrc/stats_pool_bwd.cu``);
* :func:`att_pool` -- K8 (``csrc/att_pool.cu``): the masked softmax over time
  of attentive statistics pooling with its weighted mean || std; its
  backward is K8b (same source).

The rest (convolutions with SAME padding at any stride, dilation and
cardinality, the squeeze-excitation block, the attention's 1x1 convs,
gelu, mish and layer norm) is plain PyTorch.

A wrapper takes the plain version only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import threading
from typing import Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import (ATT_POOL, BN_ACT, BN_TRAIN, STATS_POOL, STATS_POOL_BWD,
                       KernelError, check_cuda, dtype_code, num_sms, ptr, stream_scratch)
from ..parallel.sharding import active_mesh, all_reduce_, all_reduce_sum

BN_MOMENTUM = 0.997
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


def same_pads(n: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA's SAME padding of one axis of length ``n``: ceil(n / stride)
    outputs, ``total = max((out - 1) * stride + (k - 1) * dilation + 1 - n,
    0)`` zeros, ``total // 2`` before and the rest after (asymmetric at
    stride 2 and even n)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """Bias-free conv; ``weight`` is OIHW ``(out, in / cardinality, kh, kw)``,
    the JAX HWIO kernel transposed (3, 2, 0, 1). ``padding`` is ``"SAME"``
    (XLA's rule, :func:`same_pads`, at any stride and dilation) or
    ``"VALID"``; ``cardinality`` is the group count (``F.conv2d(groups=)``;
    autograd gives both gradients). Computed in the input's dtype."""

    def __init__(self, in_channels: int, features: int, kernel_size=1,
                 strides=1, padding: str = "SAME", dilation=1, cardinality: int = 1):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
        if in_channels % cardinality or features % cardinality:
            raise ValueError(f"{in_channels} -> {features} channels in {cardinality} groups")
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.dilation = _pair(dilation)
        self.padding = padding
        self.cardinality = cardinality
        self.weight = nn.Parameter(
            torch.empty(features, in_channels // cardinality, *self.kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0)
        if self.padding == "SAME":
            (ht, hb), (wl, wr) = (same_pads(n, k, s, d) for n, k, s, d in zip(
                x.shape[2:], self.kernel_size, self.strides, self.dilation))
            if (ht, wl) == (hb, wr):
                pad = (ht, wl)
            else:
                x = F.pad(x, (wl, wr, ht, hb))
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.strides, padding=pad,
                     dilation=self.dilation, groups=self.cardinality)
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in x's dtype, rounding where the JAX package does."""
    return x * 0.5 * (1.0 + torch.erf(x / torch.tensor(math.sqrt(2.0), dtype=x.dtype)))


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Parameterless layer norm over the channels (the JAX package's last
    NHWC axis), float32, eps 1e-5, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + BN_EPSILON)).to(x.dtype)


ACTIVATIONS = {"relu": torch.relu, "gelu": gelu, "mish": mish}


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

    x, shortcut: (B, C, T, F) channels_last, any C (the path by shape,
    :func:`bn_act_plan`); mean, var: (C,) float32 running statistics; mask:
    (B, T') float 0/1 with T' >= T.
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
    plan = bn_act_plan(tuple(x.shape), x.dtype)
    if plan["design"] == "fold" and any(t.data_ptr() % 16 for t in (x, shortcut, out)
                                        if t is not None):
        plan = _BN_ACT_SINGLE  # the folded path moves 16-byte aligned vectors
    BN_ACT.launch(
        "bn_act", x.device, dtype_code(x.dtype), ptr(x), ptr(mean), ptr(var),
        ptr(shortcut), ptr(shortcut_mean), ptr(shortcut_var), ptr(m), ptr(out),
        x.numel(), c, f, int(relu), sc_mode, eps, num_sms(x.device), plan["fold"],
        path=plan["design"])
    return out


_BN_ACT_SINGLE = {"design": "single", "fold": 0}


@functools.lru_cache(maxsize=None)
def bn_act_plan(shape, dtype: torch.dtype) -> dict:
    """K3's path for a (B, C, T, F) call: ``"vec"`` (4-channel vectors) where
    C % 4 == 0; else ``"fold"``, 16-byte vectors over super-rows of ``fold``
    positions (``fold`` = vec / gcd(C, vec), vec the elements of 16 bytes:
    the fewest consecutive positions whose channels fill whole vectors), where
    F % fold == 0 (one mask row a super-row) and a super-row holds at most 256
    vectors; else ``"single"`` (one element a thread). ``fold`` is 0 off the
    folded path. The wrapper also needs 16-byte aligned tensors for the fold.
    Cached per signature and shared: callers do not modify a plan."""
    c, f = shape[1], shape[3]
    if c % 4 == 0:
        return {"design": "vec", "fold": 0}
    vec = 16 // dtype.itemsize
    fold = vec // math.gcd(c, vec)
    if f % fold or c * fold // vec > 256:
        return _BN_ACT_SINGLE
    return {"design": "fold", "fold": fold}


def _update_factors(x: torch.Tensor, groups: int, n: Optional[int] = None):
    """(rows per group, weight of the new mean, weight of the new variance)
    of the running update. The variance carries Bessel's n/(n-1) on 4-D
    inputs only: the reference's fused 4-D batch norm updates with the
    unbiased variance, its 2-D head BNs with the biased one
    (JAX ops/nn.py:156-169). The products are taken in double, as the JAX
    package takes them, and rounded to float32 once. ``n`` overrides the
    rows a group of x would hold (a group that spans ranks)."""
    if n is None:
        n = (x.shape[0] // groups) * math.prod(x.shape[2:])
    bessel = n / (n - 1) if (n > 1 and x.ndim >= 4) else 1.0
    return n, 1.0 - BN_MOMENTUM, (1.0 - BN_MOMENTUM) * bessel


_UPDATE = threading.local()


@contextlib.contextmanager
def running_update(enabled: bool) -> Iterator[None]:
    """Whether training BN (:func:`bn_train`, K5 and its plain version)
    updates the running statistics in this thread, inside the block. A
    rematerialized block's recomputed forward runs with ``False``: its batch
    statistics are those of the first forward, which already applied the
    update (``models/res2net.py:remat_block``). The flag is per thread
    because autograd runs the recompute on its own thread for CUDA
    tensors."""
    before = getattr(_UPDATE, "off", False)
    _UPDATE.off = not enabled
    try:
        yield
    finally:
        _UPDATE.off = before


def running_update_enabled() -> bool:
    return not getattr(_UPDATE, "off", False)


def _group_normalize(x, running_mean, running_var, groups, eps, update=True):
    """Plain grouped training BN of one input: float32 moments per (group,
    channel), E[x^2] - mean^2; running statistics updated in place with the
    mean over groups (unless ``update`` is False); the output cast to x's
    dtype."""
    b, c = x.shape[:2]
    if b % groups:
        raise ValueError(f"batch {b} not divisible into {groups} BN groups")
    # (G, n, C): channels last, each group's rows contiguous (a view of a
    # channels_last activation)
    rows = x.movedim(1, -1)
    xg = rows.float().reshape(groups, -1, c)
    mean = xg.mean(dim=1)
    var = torch.square(xg).mean(dim=1) - torch.square(mean)
    if update:
        _, upd_mean, upd_var = _update_factors(x, groups)
        with torch.no_grad():
            running_mean.copy_(BN_MOMENTUM * running_mean + upd_mean * mean.detach().mean(0))
            running_var.copy_(BN_MOMENTUM * running_var + upd_var * var.detach().mean(0))
    y = (xg - mean[:, None]) * torch.rsqrt(var[:, None] + eps)
    return y.reshape(rows.shape).movedim(-1, 1).to(x.dtype)


def bn_train_reference(x, running_mean, running_var, *, groups=1, relu=False,
                       shortcut=None, shortcut_running_mean=None,
                       shortcut_running_var=None, eps=BN_EPSILON,
                       update=True) -> torch.Tensor:
    """Plain version of :func:`bn_train`, differentiable by autograd; each
    normalized term is cast to the dtype before the add, as in the JAX
    package. ``update=False`` leaves the running statistics as they are."""
    y = _group_normalize(x, running_mean, running_var, groups, eps, update)
    if shortcut is not None:
        if shortcut_running_mean is not None:
            shortcut = _group_normalize(shortcut, shortcut_running_mean,
                                        shortcut_running_var, groups, eps, update)
        y = y + shortcut
    if relu:
        y = torch.relu(y)
    return y.contiguous(memory_format=CHANNELS_LAST) if y.ndim == 4 else y


def _bn_chunks(channels: int, n: int, groups: int, sms: int) -> int:
    """Row chunks per group of K5's reductions: about four blocks per SM, at
    least one row lane per chunk (the C side derives the rest of the
    geometry from the channel count alone: 4-channel vectors where C % 4 ==
    0, single channels otherwise)."""
    cv = channels // 4 if channels % 4 == 0 else channels
    cpb = min(cv, 256)
    rpb, tiles = 256 // cpb, -(-cv // cpb)
    want = -(-4 * sms // (groups * tiles))
    return max(1, min(want, -(-n // rpb), 4096))


_BN_CLUSTER_THREADS = 512  # at most, per CTA of K5's cluster design
_SMEM_BYTES = 232448       # the most shared memory one block can take (227 KB)
_BN_SMEM_SLACK = 1024      # left for the kernels' static shared memory
_BN_RING_STAGES = 4        # chunks in flight in the bulk-copy ring (at most 16)


_HEAD_THREADS = 256  # at most, per CTA of K5's head design
_HEAD_ROWS = 8       # rows a thread of the head design keeps in registers at once
_HEAD_SMS = 132      # the H100's SMs: the channel tiles should give as many CTAs
# CTAs of 128 threads an H100 holds at once (three an SM, at the ~150
# registers a thread the heads' kernels take below 129 threads)
_HEAD_RESIDENT_128 = 3 * _HEAD_SMS


@functools.lru_cache(maxsize=None)
def bn_head_plan(rows: int, channels: int, groups: int, dtype: torch.dtype,
                 aligned: bool = True) -> dict:
    """K5's head design for a 2-D (B, C) call, one launch a direction: a CTA
    owns ``cl`` channel lanes of ``v`` channels across all B rows (all G
    groups); its ``rl`` row lanes own ``slab`` consecutive rows each, inside
    one group (slab divides n = B / G), so a group is rl / G row lanes.

    - Lanes (``"lanes"``): ``"vector"``, 16 bytes (``v`` = 8 bf16 or 4
      float32 channels), where C % v == 0, the tensors are 16-byte aligned
      (``aligned``) and the vectors give at least 132 of them (the card's
      SMs); else ``"single"``, one channel a lane (v = 1): by shape or
      alignment, never on failure. The small head calls ((256, 192): 24
      bf16 vectors) take single channels, spreading a call that the launch
      and a thread's serial work bound over 8x the lanes (PERF.md, PR 19).
    - ``slab``: the largest divisor of n up to 8 (one read, the slab in
      registers: 8 rows of 16 bytes are 32 registers an operand); where B /
      slab row lanes would not fit a CTA of 256 threads, the smallest
      divisor of n that fits, read in rounds of 8 rows, the second pass
      from L2. A CTA thus holds B = 2048 rows on chip at one channel lane
      (256 x 8), 256 at eight; more groups than 256 do not fit at all. On
      vector lanes, a call whose CTAs hold fewer than 256 threads an SM
      in all takes the next smaller divisors while the CTA stays within
      256 threads (ECAPA's (256, 3072): slab 2, 2 vectors x 128 row lanes).
    - ``cl``, a power of two: on vector lanes, the widest of 8, 4 and 2
      (128 to 32 bytes of a row) whose CTAs of at most 128 threads number
      132 to 396 (all resident at three an SM, with the registers the
      kernel wants); else the widest up to 8 that keeps 256 threads a CTA
      and 132 CTAs (two CTAs an SM: the kernel is built for 128 registers a
      thread there). The bench's pre_bn takes 4 x 32 (320 CTAs), dpn68's
      and the larger ones 8 x 32, TDNN's 2 x 128. On single lanes, the
      widest up to 32 that keeps 256 threads a CTA.

    Also ``threads`` (cl * rl), ``ctas``, ``rounds`` (reads of the slab in
    rounds of 8 rows), and per direction the shared memory of the tree
    (``fwd_smem`` / ``bwd_smem`` at the most quantities a direction sums:
    4 and 3 floats a channel and thread) and the registers that hold the
    slab (``fwd_tile_regs`` / ``bwd_tile_regs`` at the most operands: 2
    and 3). Cached per signature and shared: callers do not modify it."""
    if rows % groups:
        raise ValueError(f"batch {rows} not divisible into {groups} BN groups")
    n = rows // groups
    vec = 16 // dtype.itemsize
    v = vec if channels % vec == 0 and aligned and channels // vec >= _HEAD_SMS else 1
    divisors = [d for d in range(1, n + 1) if n % d == 0]
    slab = max(d for d in divisors if d <= _HEAD_ROWS)
    if rows // slab > _HEAD_THREADS:
        fit = [d for d in divisors if rows // d <= _HEAD_THREADS]
        if not fit:
            raise KernelError(f"bn_train: {groups} BN groups of a 2-D input; the head "
                              f"design holds at most {_HEAD_THREADS}")
        slab = fit[0]
    rl = rows // slab
    lanes = channels // v

    def ctas(c):
        return -(-lanes // c)

    if v == 1:
        cl = 32
        while cl > 1 and cl * rl > _HEAD_THREADS:
            cl //= 2
    else:
        small = [c for c in (8, 4, 2) if c * rl <= _HEAD_THREADS // 2
                 and _HEAD_SMS <= ctas(c) <= _HEAD_RESIDENT_128]
        cl = small[0] if small else 8
        while not small and cl > 1 and (cl * rl > _HEAD_THREADS or ctas(cl) < _HEAD_SMS):
            cl //= 2
        # a call too small to give the card 256 threads an SM takes thinner
        # slabs, more row lanes
        while ctas(cl) * cl * rl < _HEAD_SMS * _HEAD_THREADS:
            thinner = [d for d in divisors if d < slab and cl * (rows // d) <= _HEAD_THREADS]
            if not thinner:
                break
            slab = thinner[-1]
            rl = rows // slab
    threads = cl * rl
    reg = 4 if v > 1 else 1  # registers a row of one operand
    held = min(slab, _HEAD_ROWS)
    return {"design": "head", "lanes": "vector" if v > 1 else "single", "v": v, "cl": cl,
            "rl": rl, "slab": slab, "threads": threads, "ctas": ctas(cl),
            "rows": rows, "n": n, "rounds": -(-slab // _HEAD_ROWS),
            "fwd_smem": 4 * 4 * v * threads, "bwd_smem": 4 * 3 * v * threads,
            "fwd_tile_regs": 2 * held * reg, "bwd_tile_regs": 3 * held * reg}


@functools.lru_cache(maxsize=None)
def bn_train_plan(shape, groups: int, dtype: torch.dtype, sc_mode: int, relu: bool,
                  aligned: bool = True) -> dict:
    """K5's launch design for one call: ``"head"`` (:func:`bn_head_plan`,
    one launch per direction) for a 2-D input, its lanes chosen by C and
    ``aligned`` (every tensor 16-byte aligned); ``"cluster"`` (one launch
    per direction) for a 4-D input whose (super-)rows fill 16-byte vectors,
    at most 512 of them a row; else ``"multi"`` (statistics, finalize and
    elementwise launches; 4-D calls only, where the wrapper also sends a
    4-D call whose tensors are off a 16-byte boundary). A super-row is ``fold``
    consecutive rows (positions of C channels): 1 where C % vec == 0 (vec
    the elements of 16 bytes), else a multiple of k = vec / gcd(C, vec), the
    fewest rows that fill whole vectors (4 for dpn68's 10 bf16 channels: 80
    bytes, 5 vectors), that divides the rows of a group n (``rows``; none:
    the multi-kernel design) and gives the CTA the most threads (ties: the
    smaller fold). At 5 vectors a super-row the CTA would hold 5 x 64 = 320
    threads, 10 warps, too few to hide the latency of the element arithmetic
    in bf16; dpn68's stem takes fold 100 (125 vectors x 4 row lanes, 500
    threads). Each group then starts 16-byte aligned (n * C * itemsize is a
    multiple of 16). For the cluster design
    also its geometry: CTAs of ``ct_v * rpb`` threads, ``ct_v`` 16-byte
    vectors (the full super-row) by ``rpb`` row lanes (a power of two), one
    CTA an SM, and for each direction its ring of bulk copies:
    ``*_ring_bytes`` of shared memory in ``*_stages`` chunks of
    ``*_ring_rows`` super-rows of each tensor a pass streams (at most), and
    its shared memory in all. The kernel folds the super-channel sums into C
    channels inside each CTA, so its other shared arrays hold C channels
    (rounded up to a multiple of 4). The kernel sets the cluster size and
    the clusters per group itself: as many as the card holds at once. Plans
    are cached per call signature and shared: callers read them and do not
    modify them."""
    vec = 16 // dtype.itemsize
    c = shape[1]
    if len(shape) == 2:
        return bn_head_plan(shape[0], c, groups, dtype, aligned)
    if len(shape) != 4:
        return {"design": "multi"}
    n = (shape[0] // groups) * math.prod(shape[2:])
    k = vec // math.gcd(c, vec)
    best = None  # (threads, fold)
    for fold in range(k, (1 if k == 1 else _BN_CLUSTER_THREADS) * k + 1, k):
        ct_v = c * fold // vec
        if ct_v > _BN_CLUSTER_THREADS:
            break
        if n % fold == 0:
            threads = ct_v * (1 << ((_BN_CLUSTER_THREADS // ct_v).bit_length() - 1))
            if best is None or threads > best[0]:
                best = (threads, fold)
    if best is None:
        return {"design": "multi"}
    fold = best[1]
    ct_v = c * fold // vec
    rpb = best[0] // ct_v
    row = c * fold * dtype.itemsize
    plan = {"design": "cluster", "fold": fold, "ct_v": ct_v, "rpb": rpb,
            "threads": ct_v * rpb, "rows": n}
    bwd_operands = 2 + int(sc_mode == 2 or (sc_mode == 1 and relu))
    for name, ns, streamed in (("fwd", 4 if sc_mode == 2 else 2, 2 if sc_mode else 1),
                               ("bwd", 3 if sc_mode == 2 else 2, bwd_operands)):
        fixed = 4 * (plan["threads"] * vec + (2 * ns + 4) * (-(-c // 4) * 4))
        ring = (_SMEM_BYTES - _BN_SMEM_SLACK - fixed) // 16 * 16
        # large chunks: each one costs the CTA a barrier and a refill
        rows = max(1, ring // (_BN_RING_STAGES * streamed * row * rpb)) * rpb
        plan[f"{name}_ring_bytes"] = ring
        plan[f"{name}_ring_rows"] = rows
        plan[f"{name}_stages"] = min(16, ring // (streamed * rows * row))
        plan[f"{name}_smem"] = fixed + ring
    return plan


# (device, stream, groups) -> the int32 barrier and ticket words of K5's
# cluster design; (device, stream) -> its float32 scratch
_SYNC = {}
_SCRATCH = {}


def _cluster_scratch(device: torch.device, groups: int, floats: int) -> Tuple[int, int]:
    """Pointers to the cluster design's scratch on the current stream: its
    2 * groups + 1 sync ints (arrivals and generation per group, the
    running update's ticket; zero when made, and every launch leaves them
    ready for the next one; their layout depends on the group count, so
    each count has its own) and at least ``floats`` floats (the groups'
    variances, the clusters' sums). Launches on one stream run in order, so
    each stream keeps one of each."""
    stream = torch.cuda.current_stream(device).cuda_stream
    sync = _SYNC.get((device, stream, groups))
    if sync is None:
        sync = _SYNC[(device, stream, groups)] = torch.zeros(
            2 * groups + 1, dtype=torch.int32, device=device)
    buf = _SCRATCH.get((device, stream))
    if buf is None or buf.numel() < floats:
        buf = _SCRATCH[(device, stream)] = torch.empty(floats, dtype=torch.float32,
                                                       device=device)
    return sync.data_ptr(), buf.data_ptr()


def _cluster_floats(x: torch.Tensor, groups: int, ns: int) -> Tuple[int, int]:
    """(floats of the groups' variances, floats of the clusters' sums):
    2 * groups * C, and ``ns`` sums of C channels for as many clusters as
    the card holds (at most one CTA per SM). C, not C * fold: each CTA folds
    its super-channel sums before it hands them on."""
    c = x.shape[1]
    return 2 * groups * c, num_sms(x.device) * ns * c


class _BNTrainFn(torch.autograd.Function):
    """K5 forward and backward, in the design :func:`bn_train_plan` picks.
    The running statistics are updated in place by the forward launch
    (unless ``update`` is False: the kernel then gets null running-statistic
    pointers and leaves them alone); they take no gradient. The cluster and
    head designs' backward recomputes the relu decision from x (and a
    normalized shortcut), so it saves the forward output only for a raw
    shortcut under relu; the multi-kernel design saves it under relu."""

    @staticmethod
    def forward(ctx, x, shortcut, running_mean, running_var, sc_running_mean,
                sc_running_var, groups, relu, eps, update):
        sc_mode = 0 if shortcut is None else (2 if sc_running_mean is not None else 1)
        if not update:  # null pointers: the kernels skip the running update
            running_mean = running_var = sc_running_mean = sc_running_var = None
        c = x.shape[1]
        n, upd_mean, upd_var = _update_factors(x, groups)
        aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (x, shortcut))
        plan = bn_train_plan(x.shape, groups, x.dtype, sc_mode, relu, aligned)
        if plan["design"] == "cluster" and not aligned:
            plan = {"design": "multi"}  # the bulk copies move 16-byte aligned rows
        f32 = dict(dtype=torch.float32, device=x.device)
        stats = torch.empty((4 if sc_mode == 2 else 2, groups, c), **f32)
        out = torch.empty_like(x)
        mean, rstd = stats[0], stats[1]
        sc_mean, sc_rstd = (stats[2], stats[3]) if sc_mode == 2 else (None, None)
        chunks = 0
        if plan["design"] == "cluster":
            nvar, floats = _cluster_floats(x, groups, 4 if sc_mode == 2 else 2)
            sync, var = _cluster_scratch(x.device, groups, nvar + floats)
            BN_TRAIN.launch(
                "bn_cluster_fwd", x.device, dtype_code(x.dtype), ptr(x), ptr(shortcut),
                sc_mode, int(relu), n, groups, c, plan["fold"], plan["ct_v"], plan["rpb"],
                plan["fwd_ring_rows"], plan["fwd_ring_bytes"], ptr(mean), ptr(rstd),
                ptr(running_mean), ptr(running_var), ptr(sc_mean), ptr(sc_rstd),
                ptr(sc_running_mean), ptr(sc_running_var), var, var + 4 * nvar, floats,
                sync, BN_MOMENTUM, upd_mean, upd_var, eps, ptr(out), path=_cluster_path(plan))
            save_y = relu and sc_mode == 1
        elif plan["design"] == "head":
            BN_TRAIN.launch(
                "bn_head_fwd", x.device, dtype_code(x.dtype), ptr(x), ptr(shortcut), sc_mode,
                int(relu), x.shape[0], groups, c, plan["v"], plan["cl"], plan["rl"],
                plan["slab"], ptr(mean), ptr(rstd), ptr(running_mean), ptr(running_var),
                ptr(sc_mean), ptr(sc_rstd), ptr(sc_running_mean), ptr(sc_running_var),
                BN_MOMENTUM, upd_mean, upd_var, eps, ptr(out), path=plan["lanes"])
            save_y = relu and sc_mode == 1
        else:
            sms = num_sms(x.device)
            chunks = _bn_chunks(c, n, groups, sms)
            part = torch.empty(2 * groups * chunks * c, **f32)
            BN_TRAIN.launch(
                "bn_train_fwd", x.device, dtype_code(x.dtype), ptr(x), ptr(shortcut),
                sc_mode, int(relu), n, groups, c, chunks, ptr(mean), ptr(rstd),
                ptr(running_mean), ptr(running_var), ptr(sc_mean), ptr(sc_rstd),
                ptr(sc_running_mean), ptr(sc_running_var), BN_MOMENTUM, upd_mean,
                upd_var, eps, ptr(part), ptr(out), sms)
            save_y = relu
        ctx.save_for_backward(x, out if save_y else None,
                              shortcut if sc_mode == 2 else None, stats)
        ctx.config = (groups, sc_mode, relu, n, plan, chunks)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, y, shortcut, stats = ctx.saved_tensors
        groups, sc_mode, relu, n, plan, chunks = ctx.config
        dy = _kernel_layout(dy)
        c = x.shape[1]
        dx = torch.empty_like(x)
        dsc = torch.empty_like(x) if sc_mode else None
        sc_stats = (ptr(stats[2]), ptr(stats[3])) if sc_mode == 2 else (None, None)
        if plan["design"] == "cluster":
            if dy.data_ptr() % 16:
                dy = dy.clone(memory_format=CHANNELS_LAST)  # the bulk copies need 16 B
            _, floats = _cluster_floats(x, groups, 3 if sc_mode == 2 else 2)
            sync, gpart = _cluster_scratch(x.device, groups, floats)
            BN_TRAIN.launch(
                "bn_cluster_bwd", x.device, dtype_code(x.dtype), ptr(x), ptr(y), ptr(dy),
                ptr(shortcut), sc_mode, int(relu), n, groups, c, plan["fold"], plan["ct_v"],
                plan["rpb"], plan["bwd_ring_rows"], plan["bwd_ring_bytes"], ptr(stats[0]),
                ptr(stats[1]), *sc_stats, gpart, floats, sync, ptr(dx), ptr(dsc),
                path=_cluster_path(plan))
        elif plan["design"] == "head":
            if plan["v"] > 1 and dy.data_ptr() % 16:
                dy = dy.clone()  # the vector lanes load 16 bytes
            BN_TRAIN.launch(
                "bn_head_bwd", x.device, dtype_code(x.dtype), ptr(x), ptr(y), ptr(dy),
                ptr(shortcut), sc_mode, int(relu), x.shape[0], groups, c, plan["v"],
                plan["cl"], plan["rl"], plan["slab"], ptr(stats[0]), ptr(stats[1]),
                *sc_stats, ptr(dx), ptr(dsc), path=plan["lanes"])
        else:
            f32 = dict(dtype=torch.float32, device=x.device)
            part = torch.empty(3 * groups * chunks * c, **f32)
            coef = torch.empty(3 * groups * c, **f32)
            BN_TRAIN.launch(
                "bn_train_bwd", x.device, dtype_code(x.dtype), ptr(x), ptr(y), ptr(dy),
                ptr(shortcut), sc_mode, n, groups, c, chunks, ptr(stats[0]),
                ptr(stats[1]), *sc_stats, ptr(part), ptr(coef), ptr(dx), ptr(dsc),
                num_sms(x.device))
        return dx, dsc, None, None, None, None, None, None, None, None


def _cluster_path(plan: dict) -> str:
    """The launch count a cluster-design call goes to: ``"fold"`` where its
    rows are folded into super-rows, else ``"row"``."""
    return "fold" if plan["fold"] > 1 else "row"


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """A 4-D tensor in channels_last memory, a 2-D one contiguous."""
    return t.contiguous(memory_format=CHANNELS_LAST if t.ndim == 4 else torch.contiguous_format)


# ---------------------------------------------------------------------------
# K5's spanning mode: BN groups that span the data ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpanLayout:
    """Where one rank's rows lie among the BN groups of the global batch, in
    rows of C channels (a batch row of a 4-D input is T * F of them): the
    rank's ``nloc`` rows start at global row ``offset``; a group is
    ``ngroup`` consecutive global rows, ``groups`` of them."""
    nloc: int
    offset: int
    ngroup: int
    groups: int

    @property
    def touched(self) -> int:
        """The groups this rank's rows meet."""
        return (self.offset + self.nloc - 1) // self.ngroup - self.offset // self.ngroup + 1

    @staticmethod
    def of(x: torch.Tensor, groups: int, rank: int, ranks: int) -> "SpanLayout":
        """Data rank ``rank`` of ``ranks`` holding batch block ``x`` (every
        rank an equal block, in rank order)."""
        per = math.prod(x.shape[2:])
        total = x.shape[0] * ranks
        if total % groups:
            raise ValueError(f"global batch {total} not divisible into {groups} BN groups")
        return SpanLayout(x.shape[0] * per, rank * x.shape[0] * per, total // groups * per,
                          groups)


def _span_rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, C) float32 view of x in its channels-last row order."""
    return x.movedim(1, -1).float().reshape(-1, x.shape[1])


def _span_segments(layout: SpanLayout):
    """(group, local rows [lo, hi)) of each group this rank's rows meet."""
    g0 = layout.offset // layout.ngroup
    for g in range(g0, g0 + layout.touched):
        lo = max(g * layout.ngroup, layout.offset) - layout.offset
        hi = min((g + 1) * layout.ngroup, layout.offset + layout.nloc) - layout.offset
        yield g, lo, hi


def bn_span_partials_reference(x: torch.Tensor, layout: SpanLayout) -> torch.Tensor:
    """Plain version of the spanning mode's statistics launch: this rank's
    float32 sum(x), sum(x^2) per (group, channel), (G, 2, C), zero for the
    groups it holds no row of (``_group_normalize``'s moments, split by
    rows); differentiable. Each group's rows are contiguous and summed by
    one reduction (a row-by-row accumulation would stray ~n * eps)."""
    rows = _span_rows(x)
    g0, c = layout.offset // layout.ngroup, x.shape[1]
    parts = [torch.stack([rows[lo:hi].sum(0), torch.square(rows[lo:hi]).sum(0)])
             for _, lo, hi in _span_segments(layout)]
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=x.device)
    return torch.cat([zeros((g0, 2, c)), torch.stack(parts),
                      zeros((layout.groups - g0 - layout.touched, 2, c))])


def _span_normalize_reference(x, sums, running_mean, running_var, layout, eps, update):
    """Normalize this rank's rows with the global sums (G, 2, C), group by
    group; the running update from the groups' moments, as
    ``_group_normalize``."""
    mean = sums[:, 0] / layout.ngroup
    var = sums[:, 1] / layout.ngroup - torch.square(mean)
    if update:
        _, upd_mean, upd_var = _update_factors(x, layout.groups, layout.ngroup)
        with torch.no_grad():
            running_mean.copy_(BN_MOMENTUM * running_mean + upd_mean * mean.detach().mean(0))
            running_var.copy_(BN_MOMENTUM * running_var + upd_var * var.detach().mean(0))
    rows = _span_rows(x)
    y = torch.cat([(rows[lo:hi] - mean[g]) * torch.rsqrt(var[g] + eps)
                   for g, lo, hi in _span_segments(layout)])
    return y.reshape(x.movedim(1, -1).shape).movedim(-1, 1).to(x.dtype)


def bn_span_reference(x, running_mean, running_var, layout: SpanLayout, group, *,
                      relu=False, shortcut=None, shortcut_running_mean=None,
                      shortcut_running_var=None, eps=BN_EPSILON, update=True):
    """Plain version of :func:`bn_span`: the partial sums of this rank's
    rows, summed over ``group`` by a differentiable all-reduce, then
    :func:`bn_train_reference`'s normalize and epilogue; differentiable by
    autograd."""
    sums = bn_span_partials_reference(x, layout)
    if shortcut_running_mean is not None:
        sums = torch.stack([sums, bn_span_partials_reference(shortcut, layout)])
        sums = all_reduce_sum(sums, group)
        shortcut = _span_normalize_reference(shortcut, sums[1], shortcut_running_mean,
                                             shortcut_running_var, layout, eps, update)
        sums = sums[0]
    else:
        sums = all_reduce_sum(sums, group)
    y = _span_normalize_reference(x, sums, running_mean, running_var, layout, eps, update)
    if shortcut is not None:
        y = y + shortcut
    if relu:
        y = torch.relu(y)
    return y.contiguous(memory_format=CHANNELS_LAST) if y.ndim == 4 else y


_SPAN_THREADS = 512          # at most, per CTA of K5's spanning mode
_SPAN_RING_STAGES = 2        # chunks the ring holds (large ones: a chunk costs a refill)
_SPAN_DIRECT_CTAS_PER_SM = 4  # the direct design's CTAs (no ring: little shared memory)


@functools.lru_cache(maxsize=None)
def bn_span_plan(layout: SpanLayout, channels: int, dtype: torch.dtype, sms: int) -> dict:
    """K5's spanning-mode launch plan for one rank's rows (``layout``) of
    ``channels`` channels on a card of ``sms`` SMs, shared by its four
    launches (``csrc/bn_train.cu``, span_*_kernel):

    * ``design``: ``"ring"`` where a row is whole 16-byte vectors, at most
      512 of them (a CTA streams its slab through a ring of bulk copies in
      shared memory), else ``"direct"`` (loads from global memory, in
      channel tiles of at most 512 vectors; 16-byte vectors where the row
      allows, ``vec`` 1 otherwise);
    * CTAs of ``ct * rpb`` threads: ``ct`` vectors of ``vec`` channels (a
      tile of ``cw`` channels, ``tiles`` of them) by ``rpb`` row lanes, a
      power of two;
    * ``ctas``: each CTA's (group, first row, end row, tile), rows of the
      rank, one wave of them (one an SM for the ring, which takes ~220 KB);
      every group's rows cut into ``k`` slabs, never across a group
      boundary; ``segs``: each touched group's (group, first CTA, k), its
      CTAs slab-major (``first + j * tiles + t``);
    * the ring: ``ring_bytes`` of shared memory in chunks of
      ``ring_rows[ni - 1]`` rows for a launch that streams ``ni`` tensors
      (``_SPAN_RING_STAGES`` chunks), and ``smem``, a CTA's dynamic shared
      memory (its reduction buffer and the ring).

    Cached per layout; callers read plans and do not modify them."""
    size = dtype.itemsize
    vecn = 16 // size
    if channels % vecn == 0 and channels // vecn <= _SPAN_THREADS:
        design, vec = "ring", vecn
    else:
        design, vec = "direct", vecn if channels % vecn == 0 else 1
    cv = channels // vec
    tiles = -(-cv // _SPAN_THREADS)
    ct = -(-cv // tiles)
    rpb = 1 << ((_SPAN_THREADS // ct).bit_length() - 1)
    threads = ct * rpb
    per_tile = max(1, sms * (1 if design == "ring" else _SPAN_DIRECT_CTAS_PER_SM) // tiles)
    ctas, segs = [], []
    for g, lo, hi in _span_segments(layout):
        n = hi - lo
        k = max(1, min(-(-per_tile * n // layout.nloc), -(-n // rpb)))
        segs.append((g, len(ctas), k))
        ctas.extend((g, lo + n * j // k, lo + n * (j + 1) // k, t)
                    for j in range(k) for t in range(tiles))
    fixed = 4 * threads * vec
    ring, ring_rows = 0, (0, 0, 0)
    if design == "ring":
        row = channels * size
        ring = (_SMEM_BYTES - _BN_SMEM_SLACK - fixed) // 16 * 16
        ring_rows = tuple(max(1, ring // (_SPAN_RING_STAGES * ni * row * rpb)) * rpb
                          for ni in (1, 2, 3))
    return {"design": design, "vec": vec, "cv": cv, "ct": ct, "cw": ct * vec, "tiles": tiles,
            "rpb": rpb, "threads": threads, "ctas": tuple(ctas), "segs": tuple(segs),
            "ring_bytes": ring, "ring_rows": ring_rows, "smem": fixed + ring}


@functools.lru_cache(maxsize=None)
def _span_device_plan(layout: SpanLayout, channels: int, dtype: torch.dtype,
                      device: torch.device):
    """:func:`bn_span_plan` on ``device``'s card as its launches take it:
    (plan, its CTA and segment table on the card, its ten scalars as a C int
    array for a launch streaming 1, 2 or 3 tensors)."""
    plan = bn_span_plan(layout, channels, dtype, num_sms(device))
    flat = [v for e in plan["ctas"] for v in e] + [v for e in plan["segs"] for v in e]
    table = torch.tensor(flat, dtype=torch.int64, device=device)
    ints = tuple((ctypes.c_int * 10)(
        int(plan["design"] == "ring"), plan["vec"], plan["ct"], plan["rpb"], plan["tiles"],
        plan["ring_rows"][ni - 1], plan["ring_bytes"], len(plan["ctas"]), len(plan["segs"]),
        plan["smem"]) for ni in (1, 2, 3))
    return plan, table, ints


def _span_launch_plan(x: torch.Tensor, layout: SpanLayout, ni: int, ns: int):
    """(the plan's scalars for the C entry, its table on x's card, the
    ticket, the partials' scratch) for a launch streaming ``ni`` tensors and
    summing ``ns`` quantities (0: no reduction). The ticket is one int that
    every reducing launch leaves zero."""
    plan, table, ints = _span_device_plan(layout, x.shape[1], x.dtype, x.device)
    ticket = stream_scratch(x.device, "bn_span_ticket", 1, torch.int32)
    part = stream_scratch(x.device, "bn_span_partials", len(plan["ctas"]) * ns * plan["cw"],
                          torch.float32)
    return ctypes.addressof(ints[ni - 1]), table, ticket, part


def aligned_operand(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t in the kernel layout at a 16-byte boundary (the bulk copies and
    vector loads need it): copied where a view starts elsewhere."""
    if t is None:
        return None
    t = _kernel_layout(t)
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=CHANNELS_LAST if t.ndim == 4 else torch.contiguous_format)


def bn_span_partials(x: torch.Tensor, layout: SpanLayout,
                     shortcut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's spanning statistics launch (``bn_span_stats``): this rank's
    sum(x), sum(x^2) per (group, channel), (G, 2, C) float32, zero for the
    groups it holds no row of; with ``shortcut`` (a shortcut to normalize)
    its sums too, in the same launch: (2, G, 2, C), x's first."""
    c, ni = x.shape[1], 1 if shortcut is None else 2
    x, shortcut = aligned_operand(x), aligned_operand(shortcut)
    ints, table, ticket, part = _span_launch_plan(x, layout, ni, 2 * ni)
    sums = torch.empty((ni, layout.groups, 2, c), dtype=torch.float32, device=x.device)
    BN_TRAIN.launch("bn_span_stats", x.device, dtype_code(x.dtype), ptr(x), ptr(shortcut),
                    layout.ngroup, layout.groups, c, ints, ptr(table), ptr(part), ptr(ticket),
                    ptr(sums))
    return sums[0] if shortcut is None else sums


def bn_span_apply(x, sums, running_mean, running_var, layout: SpanLayout, *, relu=False,
                  shortcut=None, shortcut_sums=None, shortcut_running_mean=None,
                  shortcut_running_var=None, eps=BN_EPSILON, update=True):
    """K5's spanning normalize launch (``bn_span_normalize``) on the global
    sums: returns (out, stats), stats (2 or 4, G, C) the (mean, rstd) of x
    [and of the normalized shortcut]. Null running statistics when
    ``update`` is False."""
    sc_mode = 0 if shortcut is None else (2 if shortcut_sums is not None else 1)
    if not update:
        running_mean = running_var = shortcut_running_mean = shortcut_running_var = None
    c = x.shape[1]
    x, shortcut = aligned_operand(x), aligned_operand(shortcut)
    _, upd_mean, upd_var = _update_factors(x, layout.groups, layout.ngroup)
    stats = torch.empty((4 if sc_mode == 2 else 2, layout.groups, c), dtype=torch.float32,
                        device=x.device)
    sc_stats = (ptr(stats[2]), ptr(stats[3])) if sc_mode == 2 else (None, None)
    out = torch.empty_like(x)
    ints, table, _, _ = _span_launch_plan(x, layout, 2 if sc_mode else 1, 0)
    BN_TRAIN.launch(
        "bn_span_normalize", x.device, dtype_code(x.dtype), ptr(x), ptr(shortcut), sc_mode,
        int(relu), layout.ngroup, layout.groups, c, ints, ptr(table), ptr(sums),
        ptr(shortcut_sums), ptr(stats[0]), ptr(stats[1]), ptr(running_mean), ptr(running_var),
        *sc_stats, ptr(shortcut_running_mean), ptr(shortcut_running_var), BN_MOMENTUM,
        upd_mean, upd_var, eps, ptr(out))
    return out, stats


def _span_third(sc_mode: int, relu: bool, shortcut, y):
    """The backward's third operand: the shortcut's input (normalized
    shortcut), the forward output (raw shortcut under relu), else None."""
    if sc_mode == 2:
        if shortcut is None:
            raise ValueError("a normalized shortcut's backward takes its input")
        return shortcut
    if sc_mode == 1 and relu:
        if y is None:
            raise ValueError("a raw shortcut under relu: the backward takes the forward output")
        return y
    return None


def bn_span_bwd_partials(x, dy, stats, layout: SpanLayout, *, sc_mode: int = 0, relu=False,
                         shortcut=None, y=None) -> torch.Tensor:
    """K5's spanning backward reduce (``bn_span_bwd_reduce``): this rank's
    sum(d), sum(d * xhat) [, sum(d * shat)] per (group, channel), (G, ns,
    C), d = dy where the forward's relu passed it. The relu decision is
    recomputed from x (and ``shortcut``, the normalized shortcut's input);
    for a raw shortcut under relu it takes ``y``, the forward output."""
    c, ns = x.shape[1], 3 if sc_mode == 2 else 2
    third = aligned_operand(_span_third(sc_mode, relu, shortcut, y))
    x, dy = aligned_operand(x), aligned_operand(dy)
    ints, table, ticket, part = _span_launch_plan(x, layout, 2 + (third is not None), ns)
    sums = torch.empty((layout.groups, ns, c), dtype=torch.float32, device=x.device)
    sc_stats = (ptr(stats[2]), ptr(stats[3])) if sc_mode == 2 else (None, None)
    BN_TRAIN.launch("bn_span_bwd_reduce", x.device, dtype_code(x.dtype), ptr(x), ptr(third),
                    ptr(dy), sc_mode, int(relu), layout.ngroup, layout.groups, c, ints,
                    ptr(table), ptr(stats[0]), ptr(stats[1]), *sc_stats, ptr(part),
                    ptr(ticket), ptr(sums))
    return sums


def bn_span_bwd_apply(x, dy, stats, sums, layout: SpanLayout, *, sc_mode: int = 0, relu=False,
                      shortcut=None, y=None):
    """K5's spanning backward elementwise launch (``bn_span_bwd_grad``) on
    the global sums: (dx, the shortcut's gradient or None); the operands
    as :func:`bn_span_bwd_partials`."""
    c = x.shape[1]
    third = aligned_operand(_span_third(sc_mode, relu, shortcut, y))
    x, dy = aligned_operand(x), aligned_operand(dy)
    dx = torch.empty_like(x)
    dsc = torch.empty_like(x) if sc_mode else None
    sc_stats = (ptr(stats[2]), ptr(stats[3])) if sc_mode == 2 else (None, None)
    ints, table, _, _ = _span_launch_plan(x, layout, 2 + (third is not None), 0)
    BN_TRAIN.launch("bn_span_bwd_grad", x.device, dtype_code(x.dtype), ptr(x), ptr(third),
                    ptr(dy), sc_mode, int(relu), layout.ngroup, layout.groups, c, ints,
                    ptr(table), ptr(stats[0]), ptr(stats[1]), *sc_stats, ptr(sums), ptr(dx),
                    ptr(dsc))
    return dx, dsc


class _BNSpanFn(torch.autograd.Function):
    """K5's spanning mode, forward and backward: the statistics launch (x's
    and a normalized shortcut's sums together), one all-reduce of the
    partial sums over the data ranks, the normalize launch; the backward
    the same with its sums. Saves no forward output, except for a raw
    shortcut under relu (the backward's relu decision needs it in place of
    the shortcut), as the cluster design does."""

    @staticmethod
    def forward(ctx, x, shortcut, running_mean, running_var, sc_running_mean,
                sc_running_var, layout, relu, eps, update, group):
        sc_mode = 0 if shortcut is None else (2 if sc_running_mean is not None else 1)
        sums = bn_span_partials(x, layout, shortcut if sc_mode == 2 else None)
        all_reduce_(sums, group)
        out, stats = bn_span_apply(
            x, sums[0] if sc_mode == 2 else sums, running_mean, running_var, layout,
            relu=relu, shortcut=shortcut, shortcut_sums=sums[1] if sc_mode == 2 else None,
            shortcut_running_mean=sc_running_mean, shortcut_running_var=sc_running_var,
            eps=eps, update=update)
        third = _span_third(sc_mode, relu, shortcut, out)
        ctx.save_for_backward(x, third, stats)
        ctx.config = (layout, sc_mode, relu, group)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, third, stats = ctx.saved_tensors
        layout, sc_mode, relu, group = ctx.config
        kw = dict(sc_mode=sc_mode, relu=relu, shortcut=third if sc_mode == 2 else None,
                  y=third if sc_mode == 1 else None)
        sums = all_reduce_(bn_span_bwd_partials(x, dy, stats, layout, **kw), group)
        dx, dsc = bn_span_bwd_apply(x, dy, stats, sums, layout, **kw)
        return dx, dsc, None, None, None, None, None, None, None, None, None


def bn_span(x, running_mean, running_var, layout: SpanLayout, group, *, relu=False,
            shortcut=None, shortcut_running_mean=None, shortcut_running_var=None,
            eps=BN_EPSILON, update=True):
    """Training BN of one data rank's rows where BN groups span ranks
    (``layout``): the statistics of group g are those of its global rows on
    every rank, summed over ``group`` (the data ranks' process group). On a
    CPU tensor :func:`bn_span_reference`; on CUDA K5's spanning mode. The
    arguments are :func:`bn_train`'s, already checked."""
    if x.device.type == "cpu":
        return bn_span_reference(
            x, running_mean, running_var, layout, group, relu=relu, shortcut=shortcut,
            shortcut_running_mean=shortcut_running_mean,
            shortcut_running_var=shortcut_running_var, eps=eps, update=update)
    return _BNSpanFn.apply(x, shortcut, running_mean, running_var, shortcut_running_mean,
                           shortcut_running_var, layout, relu, eps, update, group)


def bn_train(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
             *, groups: int = 1, relu: bool = False,
             shortcut: Optional[torch.Tensor] = None,
             shortcut_running_mean: Optional[torch.Tensor] = None,
             shortcut_running_var: Optional[torch.Tensor] = None,
             eps: float = BN_EPSILON) -> torch.Tensor:
    """Training batch norm with statistics per batch group, K5 on CUDA:

        y = relu?(BN_g(x) [+ BN_g(s)  or  + s])

    where BN_g normalizes each of ``groups`` equal batch groups with its own
    float32 mean and biased variance (E[x^2] - mean^2), and updates the
    running statistics in place: ``mom * r + (1 - mom) * mean over groups``,
    the variance with Bessel's factor on 4-D inputs only. A normalized
    shortcut (``shortcut_running_mean``/``var`` given) is the projection BN
    with its own batch statistics and its own running update.

    x, shortcut: (B, C, T, F) channels_last or (B, C), any C (the design by
    shape, :func:`bn_train_plan`);
    running statistics: (C,) float32, updated in place, except inside ``running_update(False)``
    (a rematerialized block's recompute). Differentiable in x and the
    shortcut.

    Inside a step whose mesh has data ranks (``parallel.active``), x is
    this rank's block of the global batch and ``groups`` counts the global
    batch's groups: where they lie inside each rank (``groups`` a multiple
    of the data ranks) each rank runs its own ``groups / ranks`` as above;
    else :func:`bn_span` all-reduces the groups' sums.
    """
    update = running_update_enabled()
    if shortcut is not None and shortcut.shape != x.shape:
        raise ValueError(f"shortcut {tuple(shortcut.shape)} != x {tuple(x.shape)}")
    if (shortcut_running_mean is None) != (shortcut_running_var is None) or (
            shortcut_running_mean is not None and shortcut is None):
        raise ValueError("shortcut running mean/var come together, with a shortcut")
    mesh = active_mesh()
    span = None
    if mesh is not None and mesh.num_data > 1:
        if groups % mesh.num_data == 0:
            groups //= mesh.num_data  # every group inside this rank
        else:
            span = SpanLayout.of(x, groups, mesh.data_rank, mesh.num_data)
    kw = dict(relu=relu, shortcut=shortcut, shortcut_running_mean=shortcut_running_mean,
              shortcut_running_var=shortcut_running_var, eps=eps, update=update)
    if span is None and x.shape[0] % groups:
        raise ValueError(f"batch {x.shape[0]} not divisible into {groups} BN groups")
    if x.device.type == "cpu":
        if span is not None:
            return bn_span(x, running_mean, running_var, span, mesh.data_group, **kw)
        return bn_train_reference(x, running_mean, running_var, groups=groups, **kw)

    fmt = CHANNELS_LAST if x.ndim == 4 else torch.contiguous_format
    if x.ndim not in (2, 4):
        raise KernelError(f"bn_train: expected a 2-D or 4-D input, got {tuple(x.shape)}")
    x = _kernel_layout(x)
    check_cuda("bn_train", x, _KERNEL_DTYPES, x.ndim, fmt)
    c = x.shape[1]
    for name, s in (("running_mean", running_mean), ("running_var", running_var),
                    ("shortcut_running_mean", shortcut_running_mean),
                    ("shortcut_running_var", shortcut_running_var)):
        if s is not None:
            check_cuda(f"bn_train {name}", s, (torch.float32,), 1)
            if s.shape[0] != c:
                raise KernelError(f"bn_train: {name} has {s.shape[0]} channels, x {c}")
    if shortcut is not None:
        shortcut = _kernel_layout(shortcut)
        check_cuda("bn_train shortcut", shortcut, (x.dtype,), x.ndim, fmt)
    if x.numel() == 0:
        raise KernelError("bn_train: empty batch")
    if span is not None:
        kw["shortcut"] = shortcut
        return bn_span(x, running_mean, running_var, span, mesh.data_group, **kw)
    return _BNTrainFn.apply(x, shortcut, running_mean, running_var,
                            shortcut_running_mean, shortcut_running_var, groups,
                            relu, eps, update)


class BatchNorm(nn.Module):
    """Affine-free batch norm, momentum 0.997, eps 1e-5.

    Eval mode normalizes with the ``running_mean``/``running_var`` buffers:
    on 4-D activations through :func:`bn_act` with its epilogue flags, on the
    2-D head inputs as a plain float32 normalize cast to the input dtype.
    Training mode is :func:`bn_train` over the module's ``groups`` batch
    groups, on 4-D and 2-D inputs alike; a ``mask`` is then applied after
    the epilogue."""

    def __init__(self, num_features: int, eps: float = BN_EPSILON, groups: int = 1):
        super().__init__()
        self.eps = eps
        self.groups = groups
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, training: bool = False, *,
                relu: bool = False, shortcut: Optional[torch.Tensor] = None,
                shortcut_bn: Optional["BatchNorm"] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if training:
            y = bn_train(
                x, self.running_mean, self.running_var, groups=self.groups, relu=relu,
                shortcut=shortcut,
                shortcut_running_mean=None if shortcut_bn is None else shortcut_bn.running_mean,
                shortcut_running_var=None if shortcut_bn is None else shortcut_bn.running_var,
                eps=self.eps)
            return mask_time(y, mask)
        if x.ndim == 2:
            if relu or shortcut is not None or mask is not None:
                raise ValueError("the 2-D head BN takes no epilogue")
            return _normalize(x, self.running_mean, self.running_var, self.eps)
        return bn_act(
            x, self.running_mean, self.running_var, relu=relu, shortcut=shortcut,
            shortcut_mean=None if shortcut_bn is None else shortcut_bn.running_mean,
            shortcut_var=None if shortcut_bn is None else shortcut_bn.running_var,
            mask=mask, eps=self.eps)


def set_bn_groups(model: nn.Module, groups: int) -> None:
    """Training BN statistics over ``groups`` equal batch groups in every
    BN of ``model`` (the JAX package's ``bn_groups`` context)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.groups = max(1, int(groups))


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


# K4 / K4b's layout (csrc/stats_pool.cuh): 4 warps a CTA; the ring design
# (512-byte tile rows, a warp a row) takes columns of up to 128 rows in a
# ring of 3 slabs; the column design the longer ones in 2 slabs at the
# widest of 128-, 64- and 32-byte rows that leaves room for two CTAs an SM
# (else for one); the stream design what is longer still, 256-row chunks of
# 128-byte rows, 2 in flight.
_POOL_WARPS = 4
_POOL_STAGES = 3
_POOL_COLUMN_STAGES = 2
_POOL_SM_BYTES = 233472   # an SM's shared memory (228 KB)
_POOL_CTA_BYTES = 1024 + 256  # the runtime's reserve a CTA and the static mbarriers
_POOL_RING_ROWS, _POOL_RING_ROW_BYTES = 128, 512
_POOL_COLUMN_ROW_BYTES = (32, 64, 128)
_POOL_STREAM_ROWS, _POOL_STREAM_ROW_BYTES, _POOL_STREAM_STAGES = 256, 128, 2
_POOL_DESIGNS = ("ring", "column", "stream")
_POOL_SMEM_LIMIT = _SMEM_BYTES - 1024  # a CTA's dynamic shared memory (the rest: mbarriers)
_POOL_BOX_MAX, _POOL_ALIGN = 256, 128   # a tensor copy's rows at most; the slabs' alignment


def _pool_smem(stages: int, rows: int, row_bytes: int, itemsize: int, pad: int = 0) -> int:
    """stats_pool.cuh's smem_bytes: the slabs, each slab's mask rows (16-byte
    aligned), the warps' partial sums (4 x (V + 1) x 32 floats) and ``pad``
    (the column design's room to start its slabs 128-byte aligned)."""
    part = _POOL_WARPS * (16 // itemsize + 1) * 32 * 4
    return stages * (rows * row_bytes + -(-rows // 4) * 16) + part + pad


def _pool_boxes(t: int) -> Tuple[int, int]:
    """stats_pool.cuh's box_count and box_rows: a column of t rows as that
    many tensor copies of at most 256 rows, each a multiple of 4 rows."""
    n = -(-t // _POOL_BOX_MAX)
    return n, -(-(-(-t // n)) // 4) * 4


def pool_ctas_per_sm(smem: int) -> int:
    """CTAs of K4 / K4b's layout that fit an SM's shared memory at once."""
    return _POOL_SM_BYTES // (smem + _POOL_CTA_BYTES)


def _pool_column_smem(t: int, row_bytes: int, itemsize: int) -> int:
    n, rows = _pool_boxes(t)
    return _pool_smem(_POOL_COLUMN_STAGES, n * rows, row_bytes, itemsize, _POOL_ALIGN)


@functools.lru_cache(maxsize=None)
def stats_pool_plan(batch: int, t: int, w: int, c: int, dtype: torch.dtype) -> dict:
    """K4 / K4b's launch plan for x (batch, c, t, w) of ``dtype``, as
    csrc/stats_pool.cuh lays it out (its C entries refuse another):

    * ``design``: ``"ring"`` where t <= 128 (tile rows of 512 bytes, the
      whole column in one slab, a ring of 3 slabs, by ``cp.async``);
      ``"column"`` where the column is longer and 2 slabs of it fit at 128-,
      64- or 32-byte tile rows: the widest (but no wider than c's row needs)
      whose slabs leave room for two CTAs an SM, else the widest that fits
      one; its slabs hold ``boxes`` tensor copies of ``box_rows`` rows
      (``rows`` = their product >= t; per-thread ``cp.async`` where x's rows
      are not 16-byte aligned); else ``"stream"`` (256-row chunks of 128-byte
      rows, 2 in flight, x read once a pass, by ``cp.async``);
    * ``row_bytes``, ``tile_channels`` (channels a tile row), ``tiles``
      (channel tiles a (b, f)), ``work`` (tiles of the call: each (b, f,
      channel tile) once), ``rows`` (a slab's rows), ``stages`` (slabs) and
      ``smem`` (a CTA's dynamic shared memory, at most 231,424 bytes: 227 KB
      less 1 KB);
    * ``x_reads``: the times K4 reads x from HBM (1 on chip; K4b's
      gradient pass reads it once more in the stream design only).

    Cached; callers read plans and do not modify them."""
    size = dtype.itemsize
    if t <= _POOL_RING_ROWS:
        design, rb, rows, stages = "ring", _POOL_RING_ROW_BYTES, t, _POOL_STAGES
    else:
        wide = next((r for r in _POOL_COLUMN_ROW_BYTES if r >= c * size),
                    _POOL_COLUMN_ROW_BYTES[-1])
        fits = [r for r in reversed(_POOL_COLUMN_ROW_BYTES)
                if r <= wide and _pool_column_smem(t, r, size) <= _POOL_SMEM_LIMIT]
        two = [r for r in fits if pool_ctas_per_sm(_pool_column_smem(t, r, size)) >= 2]
        if fits:
            design, rb, stages = "column", (two or fits)[0], _POOL_COLUMN_STAGES
            rows = math.prod(_pool_boxes(t))
        else:
            design, rb = "stream", _POOL_STREAM_ROW_BYTES
            rows, stages = _POOL_STREAM_ROWS, _POOL_STREAM_STAGES
    tile_channels = rb // size
    tiles = -(-c // tile_channels)
    return {"design": design, "row_bytes": rb, "tile_channels": tile_channels, "tiles": tiles,
            "work": batch * w * tiles, "rows": rows, "stages": stages,
            "smem": _pool_smem(stages, rows, rb, size, _POOL_ALIGN if design == "column" else 0),
            "boxes": _pool_boxes(t)[0] if design == "column" else 0,
            "box_rows": _pool_boxes(t)[1] if design == "column" else 0,
            "x_reads": 2 if design == "stream" else 1}


@functools.lru_cache(maxsize=None)
def _pool_plan_ints(batch: int, t: int, w: int, c: int, dtype: torch.dtype):
    """(the design's name, the plan's five ints as the C entries take them)."""
    plan = stats_pool_plan(batch, t, w, c, dtype)
    return plan["design"], pool_plan_ints(plan)


def pool_plan_ints(plan: dict):
    """A K4 / K4b plan as the C entries take it: five ints (design, tile row
    bytes, slab rows, stages, shared memory)."""
    return (ctypes.c_int * 5)(_POOL_DESIGNS.index(plan["design"]), plan["row_bytes"],
                              plan["rows"], plan["stages"], plan["smem"])


class _StatsPoolFn(torch.autograd.Function):
    """K4 forward, K4b backward (float32 moments recomputed from x)."""

    @staticmethod
    def forward(ctx, x, m):
        b, c, t, w = x.shape
        out = torch.empty((b, 2 * c, 1, w), dtype=x.dtype, device=x.device,
                          memory_format=CHANNELS_LAST)
        if out.numel():
            design, ints = _pool_plan_ints(b, t, w, c, x.dtype)
            STATS_POOL.launch("stats_pool", x.device, dtype_code(x.dtype), ptr(x),
                              ptr(m), ptr(out), b, t, w, c, POOL_EPSILON,
                              ctypes.addressof(ints), path=design)
        ctx.save_for_backward(x, m)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, m = ctx.saved_tensors
        b, c, t, w = x.shape
        dout = dout.contiguous(memory_format=CHANNELS_LAST)
        dx = torch.empty_like(x)
        if dx.numel():
            design, ints = _pool_plan_ints(b, t, w, c, x.dtype)
            STATS_POOL_BWD.launch("stats_pool_bwd", x.device, dtype_code(x.dtype),
                                  ptr(x), ptr(m), ptr(dout), ptr(dx), b, t, w, c,
                                  POOL_EPSILON, ctypes.addressof(ints), path=design)
        return dx, None


def stats_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Statistics pooling over time, K4 on CUDA (its backward K4b): (B, C, T,
    W) channels_last -> (B, 2C, 1, W) channels_last, i.e. JAX's NHWC (B, 1,
    W, 2C). Moments are float32 with denominator max(sum(mask), 1); the
    output is cast to x's dtype. Differentiable in x."""
    if x.device.type == "cpu":
        return stats_pool_reference(x, mask)
    check_cuda("stats_pool", x, _KERNEL_DTYPES, 4, CHANNELS_LAST)
    b, c, t, w = x.shape
    m = None
    if mask is not None:
        m = mask[:, :t].float().contiguous()
        if m.shape != (b, t) or m.device != x.device:
            raise KernelError(f"stats_pool: mask {tuple(mask.shape)} does not cover (B, T)=({b}, {t})")
    return _StatsPoolFn.apply(x, m)


class SqueezeExcitation(nn.Module):
    """Squeeze-and-excitation over (T, W): float32 mean (over the valid
    frames where a (B, T) ``mask`` is given, denominator max(sum(mask), 1) *
    W; x must be zero at masked frames), cast to x's dtype, then squeeze
    1x1 conv -> relu -> excite 1x1 conv -> sigmoid, scaling x."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        if channels % ratio:
            raise ValueError(f"{channels} channels at squeeze ratio {ratio}")
        self.squeeze = Conv2d(channels, channels // ratio, 1)
        self.excite = Conv2d(channels // ratio, channels, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x32 = x.float()
        if mask is None:
            scale = x32.mean(dim=(2, 3), keepdim=True)
        else:
            m = mask[:, : x.shape[2]].float()
            denom = torch.clamp(m.sum(dim=1), min=1.0) * x.shape[3]
            scale = x32.sum(dim=(2, 3), keepdim=True) / denom[:, None, None, None]
        scale = torch.relu(self.squeeze(scale.to(x.dtype)))
        return torch.sigmoid(self.excite(scale)) * x


def att_pool_reference(x: torch.Tensor, s: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`att_pool`, differentiable by autograd, step
    for step as the JAX package's ``AttStatsPool`` after ``att_conv2``
    (ops/nn.py:530-539): scores in float32, -1e30 at masked frames, softmax
    over T, weighted mean and sqrt(max(E_p[x^2] - mean^2, 0) + eps), whose
    ``torch.maximum`` passes half the gradient at a tie as ``jnp.maximum``
    does. Float64 inputs are computed in float64 (a yardstick for the
    kernel's float32 arithmetic)."""
    work = torch.promote_types(x.dtype, torch.float32)
    x32, s32 = x.to(work), s.to(work)
    if mask is not None:
        m = mask[:, : x.shape[2]].to(work)[:, None, :, None]
        s32 = torch.where(m > 0, s32, torch.full_like(s32, -1e30))
    w = torch.softmax(s32, dim=2)
    mean = (x32 * w).sum(dim=2, keepdim=True)
    sq = (x32 * x32 * w).sum(dim=2, keepdim=True)
    std = torch.sqrt(torch.maximum(sq - mean * mean, torch.zeros_like(sq)) + POOL_EPSILON)
    return torch.cat([mean, std], dim=1).to(x.dtype).contiguous(memory_format=CHANNELS_LAST)


class _AttPoolFn(torch.autograd.Function):
    """K8 forward (it saves each column's max, sum of exp, mean and E_p[x^2]
    in float32), K8b backward from them: dx and ds in one pass over x and s."""

    @staticmethod
    def forward(ctx, x, s, m):
        b, c, t, w = x.shape
        out = torch.empty((b, 2 * c, 1, w), dtype=x.dtype, device=x.device,
                          memory_format=CHANNELS_LAST)
        stats = torch.empty((4, b, w, c), dtype=torch.float32, device=x.device)
        if out.numel():
            ATT_POOL.launch("att_pool_fwd", x.device, dtype_code(x.dtype), ptr(x), ptr(s),
                            ptr(m), ptr(out), ptr(stats), b, t, w, c, POOL_EPSILON)
        ctx.save_for_backward(x, s, m, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, s, m, stats = ctx.saved_tensors
        b, c, t, w = x.shape
        dout = dout.contiguous(memory_format=CHANNELS_LAST)
        dx, ds = torch.empty_like(x), torch.empty_like(s)
        if dx.numel():
            ATT_POOL.launch("att_pool_bwd", x.device, dtype_code(x.dtype), ptr(x), ptr(s),
                            ptr(m), ptr(stats), ptr(dout), ptr(dx), ptr(ds), b, t, w, c,
                            POOL_EPSILON)
        return dx, ds, None


def att_pool(x: torch.Tensor, s: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attentive statistics pooling after the attention's scores, K8 on CUDA
    (its backward K8b): x, s (B, C, T, W) channels_last, one dtype; per (b,
    c, w), p = softmax over T of s (-1e30 at frames where the (B, T') mask is
    0, so a row masked throughout weighs its T frames alike), and the output
    (B, 2C, 1, W) channels_last is [sum p x || sqrt(max(sum p x^2 - mean^2, 0)
    + eps)] in float32, cast to x's dtype. Differentiable in x and s."""
    if s.shape != x.shape:
        raise ValueError(f"scores {tuple(s.shape)} != x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return att_pool_reference(x, s, mask)
    check_cuda("att_pool", x, _KERNEL_DTYPES, 4, CHANNELS_LAST)
    check_cuda("att_pool scores", s, (x.dtype,), 4, CHANNELS_LAST)
    b, _, t, _ = x.shape
    m = None
    if mask is not None:
        m = mask[:, :t].float().contiguous()
        if m.shape != (b, t) or m.device != x.device:
            raise KernelError(f"att_pool: mask {tuple(mask.shape)} does not cover (B, T)=({b}, {t})")
    return _AttPoolFn.apply(x, s, m)


class AttStatsPool(nn.Module):
    """Attentive statistics pooling (the JAX package's ``AttStatsPool``):
    scores = att_conv2(tanh(att_conv1([x; mean; std]))), then :func:`att_pool`.

    [mean; std] is K4's :func:`stats_pool` of x (exactly the JAX package's
    masked moments, cast to x's dtype). The JAX package materializes the
    concat (B, T, W, 3C); here att_conv1 is computed as W[:, :C] x +
    W[:, C:] [mean; std], the second term once per (b, w) and broadcast over
    T -- equal in exact arithmetic, on both devices (each product is rounded
    to the compute dtype before the add). It spares a tensor three times the
    size of x (983 MB at res2net200_att's serving batch)."""

    def __init__(self, channels: int, att_dim: int = 128):
        super().__init__()
        self.channels = channels
        self.att_conv1 = Conv2d(3 * channels, att_dim, 1)
        self.att_conv2 = Conv2d(att_dim, channels, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.channels
        w1 = self.att_conv1.weight.to(x.dtype)
        h = F.conv2d(x, w1[:, :c]) + F.conv2d(stats_pool(x, mask), w1[:, c:])
        scores = self.att_conv2(torch.tanh(h))
        return att_pool(x, scores, mask)


class EmbeddingHead(nn.Module):
    """Pool (``"stats"``: :func:`stats_pool`; ``"att_stats"``:
    :class:`AttStatsPool`) -> flatten in NHWC order (W, 2C) -> BN -> dense ->
    BN.

    The flatten keeps the downsampled frequency axis, so the dense input is
    freq_out * 2 * channels, in the JAX package's order."""

    def __init__(self, channels: int, freq: int, output_dim: int,
                 pool: str = "stats"):
        super().__init__()
        if pool not in ("stats", "att_stats"):
            raise ValueError(f"unknown pool {pool!r}")
        if pool == "att_stats":
            self.att_stats_pool = AttStatsPool(channels)
        in_features = freq * 2 * channels
        self.pre_bn = BatchNorm(in_features)
        self.embedding = Dense(in_features, output_dim)
        self.post_bn = BatchNorm(output_dim)

    def forward(self, x: torch.Tensor, training: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if hasattr(self, "att_stats_pool"):
            x = self.att_stats_pool(x, mask)
        else:
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
