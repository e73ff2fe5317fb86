"""Margin-softmax projection heads, the nine kinds of the JAX package's
``losses/projections.py``, and the training loss of the sub-center head.

``MarginProjection.forward`` returns the scaled logits (B, C) of any kind,
as plain tensor code, in the kernel's dtype (float32; the embeddings are
cast up to it). ``MarginProjection.cross_entropy`` returns the
per-row softmax cross-entropy and argmax-correct flags the trainer uses; for
``sc_cm_linear`` it is the l2-normalized products (a float32 torch matmul)
followed by K6 (``csrc/margin_ce.cu``, wrapped by :func:`margin_ce`), which
takes the max over centers, the margin, logsumexp and the gradient without
materializing the logits.

Margin math is float32 throughout. ``_l2_normalize`` is x * rsqrt(max(sum
x^2, 1e-5)) (TF's l2_normalize), not ``F.normalize``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..kernels import MARGIN_CE, KernelError, check_cuda, ptr
from ..parallel.sharding import active_mesh, all_reduce_, gather_classes

PROJECTION_NAMES = (
    "linear", "am_linear", "aam_linear", "cm_linear", "cm_linear_voxsrc2020",
    "hcm_linear", "sc_cm_linear", "sc_am_linear", "qm_linear",
)

_EPS = 1e-5


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=_EPS))


def margin_constants(margin: float) -> Tuple[float, float, float]:
    """(cos m, sin m, m^2 / 2) in float32, as the JAX package computes them
    from its float32 margin."""
    m = np.float32(margin)
    return float(np.cos(m)), float(np.sin(m)), float(np.float32(0.5) * m * m)


def target_phi(cos: torch.Tensor, label: torch.Tensor, cos_m: float, sin_m: float,
               m1: float) -> torch.Tensor:
    """cos(theta + m) - m1 = v cos m - sqrt(1 - v^2) sin m - m1 at each row's
    label column only: (B, 1) from the clipped cosines ``cos`` (B, C) and
    ``label`` (B, 1). The sqrt is taken at the label column alone, so a
    non-label cosine of exactly +-1 keeps the finite gradient of ``v``.

    The rule at the label column where |v| = 1 (sin theta = 0, where the
    derivative of the sqrt is unbounded): the gradient is zero, as at an
    element the clip holds. K6 applies the same rule. The value is the
    formula's, v cos m - m1."""
    v = cos.gather(1, label)
    st2 = 1.0 - v * v
    inside = st2 > 0
    sin = torch.where(inside, torch.sqrt(torch.where(inside, st2, torch.ones_like(st2))),
                      torch.zeros_like(st2))
    phi = v * cos_m - sin * sin_m - m1
    return torch.where(inside, phi, phi.detach())


def margin_ce_reference(cos_all: torch.Tensor, labels: torch.Tensor, scale: float,
                        margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`margin_ce`, differentiable by autograd
    (``amax`` splits the gradient among tied centers, as ``jnp.max`` does;
    the label column follows :func:`target_phi`'s rule at |v| = 1)."""
    cos = torch.clamp(torch.amax(cos_all, dim=0), -1.0, 1.0)
    label = labels.long()[:, None]
    logits = scale * cos.scatter(1, label, target_phi(cos, label, *margin_constants(margin)))
    lse = torch.logsumexp(logits, dim=1)
    loss = lse - logits.gather(1, label)[:, 0]
    correct = (logits.argmax(dim=1) == labels).float()
    return loss, correct


@functools.lru_cache(maxsize=None)
def margin_ce_plan(centers: int, classes: int) -> Tuple[str, int]:
    """K6's path for a (K, B, C) input, as csrc/margin_ce.cu picks it by
    shape: ``("slab", bytes)`` (each row staged into shared memory once; at
    most 8 centers and a 200 KB slab) or ``("stream", 0)`` (every pass reads
    the row from global memory). Asks the C side, so it needs the built
    library but no card."""
    slab = ctypes.c_int(0)
    lib = MARGIN_CE.load()
    code = lib.margin_ce_plan(centers, classes, ctypes.byref(slab))
    if code != 0:
        raise KernelError(f"margin_ce.margin_ce_plan({centers}, {classes}): error {code} "
                          f"({lib.vsv_error_string(code).decode()})")
    return ("slab" if slab.value else "stream"), slab.value


class _MarginCEFn(torch.autograd.Function):
    """K6 forward and backward (the C entry points pick the path by shape,
    :func:`margin_ce_plan` names it for the launch count); the gradient
    flows to ``cos_all`` only."""

    @staticmethod
    def forward(ctx, cos_all, labels, scale, margin):
        k, b, c = cos_all.shape
        consts = margin_constants(margin)
        path = margin_ce_plan(k, c)[0]
        out = torch.empty((3, b), dtype=torch.float32, device=cos_all.device)
        MARGIN_CE.launch("margin_ce_fwd", cos_all.device, ptr(cos_all), ptr(labels),
                         k, b, c, scale, *consts, ptr(out), path=path)
        ctx.save_for_backward(cos_all, labels, out[2])
        ctx.constants = (scale, *consts)
        ctx.path = path
        ctx.mark_non_differentiable(out[1])
        return out[0], out[1]

    @staticmethod
    def backward(ctx, dloss, _dcorrect):
        cos_all, labels, lse = ctx.saved_tensors
        k, b, c = cos_all.shape
        dloss = dloss.float().contiguous()
        dcos = torch.empty_like(cos_all)
        MARGIN_CE.launch("margin_ce_bwd", cos_all.device, ptr(cos_all), ptr(labels),
                         ptr(lse), ptr(dloss), k, b, c, *ctx.constants, ptr(dcos),
                         path=ctx.path)
        return dcos, None, None, None


def margin_ce(cos_all: torch.Tensor, labels: torch.Tensor, scale: float,
              margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-center cos-margin logits + softmax cross-entropy, K6 on CUDA:

        v = clip(max_k cos_all[k], -1, 1);  logit = scale * (v, or at the
        label cos(theta + m) - m^2/2);  loss = logsumexp(logit) - logit[y]

    cos_all: (K, B, C) float32; labels: (B,) integers. Returns the per-row
    loss (differentiable in cos_all) and the per-row 0/1 flag argmax ==
    label, both (B,) float32. Every shape runs on the card: K6 picks its
    slab or streaming path by shape (:func:`margin_ce_plan`)."""
    if cos_all.ndim != 3 or labels.shape != cos_all.shape[1:2]:
        raise ValueError(f"cos_all {tuple(cos_all.shape)}, labels {tuple(labels.shape)}")
    if cos_all.device.type == "cpu":
        return margin_ce_reference(cos_all, labels, scale, margin)
    check_cuda("margin_ce", cos_all, (torch.float32,), 3)
    labels = labels.to(device=cos_all.device, dtype=torch.int64).contiguous()
    if labels.numel() == 0:
        raise KernelError("margin_ce: empty batch")
    return _MarginCEFn.apply(cos_all, labels, float(scale), float(margin))


# ---------------------------------------------------------------------------
# class-sharded mode: the head's classes split over a model group
# ---------------------------------------------------------------------------

def combine_partials(parts: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, correct, lse) of each row from every shard's partials, parts
    (M, 4, B) in class order: max logit, sum of exp(logit - max), target
    logit (0 off its shard), first-index argmax (a global class). The argmax
    across shards is the first shard's among equal maxima (JAX's tie rule,
    the smallest index)."""
    best, sumexp, target, argmax = parts.unbind(1)
    top = best.amax(0)
    lse = top + torch.log(torch.sum(sumexp * torch.exp(best - top), 0))
    first = (best == top).float().argmax(0)  # the first shard holding the max
    pred = argmax.gather(0, first[None])[0]
    return lse - target.sum(0), (pred == labels.float()).float(), lse


def _shard_logits(cos_all, labels, scale, margin, class_offset):
    """One shard's scaled logits (B, C), the margin at the label where it
    lies in the shard, and each row's target logit (0 where it does not)."""
    c = cos_all.shape[2]
    cos = torch.clamp(torch.amax(cos_all, dim=0), -1.0, 1.0)
    local = labels.long() - class_offset
    in_shard = (local >= 0) & (local < c)
    local = torch.where(in_shard, local, torch.zeros_like(local))
    phi = target_phi(cos, local[:, None], *margin_constants(margin))
    onehot = F.one_hot(local, c).bool() & in_shard[:, None]
    logits = scale * torch.where(onehot, phi, cos)
    return logits, torch.where(in_shard, logits.gather(1, local[:, None])[:, 0], 0.0)


def _partials(logits: torch.Tensor, target: torch.Tensor, class_offset: int) -> torch.Tensor:
    best, arg = logits.max(dim=1)
    sumexp = torch.exp(logits - best[:, None]).sum(1)
    return torch.stack([best, sumexp, target, (arg + class_offset).float()])


def margin_ce_partial_reference(cos_all: torch.Tensor, labels: torch.Tensor, scale: float,
                                margin: float, class_offset: int) -> torch.Tensor:
    """Plain version of K6's partial forward (``margin_ce_partial_fwd``):
    the (4, B) partials of one class shard, ``margin_ce_reference``'s
    logits taken over classes [class_offset, class_offset + C) with global
    labels."""
    return _partials(*_shard_logits(cos_all, labels, scale, margin, class_offset),
                     class_offset)


def margin_ce_sharded_reference(cos_all: torch.Tensor, labels: torch.Tensor, scale: float,
                                margin: float, class_offset: int, group
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain class-sharded margin CE, differentiable in this shard's
    cos_all: every rank of ``group`` gets the rows' global loss and correct
    flags; the gradient is that of the loss with respect to this shard's
    classes (the global softmax over them, minus the label's one-hot where it
    lies here), so summing the embedding's gradient over the group gives the
    whole head's. ``group`` None: this shard is the whole head."""
    logits, target = _shard_logits(cos_all, labels, scale, margin, class_offset)
    loss, correct, lse = _all_reduce_partials(
        _partials(logits.detach(), target.detach(), class_offset), labels, group)
    # the value lse - target; the gradient softmax(global) - onehot on this shard
    shard_lse = torch.logsumexp(logits, dim=1)
    weight = torch.exp(shard_lse.detach() - lse)
    return loss + weight * (shard_lse - shard_lse.detach()) - (target - target.detach()), correct


def _all_reduce_partials(parts: torch.Tensor, labels: torch.Tensor, group):
    """Every shard's (4, B) partials to every rank of the model group in one
    all-reduce (each rank fills its own slot of a zeroed (M, 4, B) buffer),
    combined into (loss, correct, lse). ``group`` None: this shard alone."""
    labels = labels.to(parts.device)
    if group is None:
        return combine_partials(parts[None], labels)
    buf = parts.new_zeros((dist.get_world_size(group),) + tuple(parts.shape))
    buf[dist.get_rank(group)] = parts
    return combine_partials(all_reduce_(buf, group), labels)


def margin_ce_partials(cos_all: torch.Tensor, labels: torch.Tensor, scale: float,
                       margin: float, class_offset: int) -> torch.Tensor:
    """K6's partial forward launch (``margin_ce_partial_fwd``): one class
    shard's (4, B) partials (see :func:`combine_partials`); cos_all a
    contiguous float32 CUDA tensor, labels int64 on its device."""
    k, b, c = cos_all.shape
    parts = torch.empty((4, b), dtype=torch.float32, device=cos_all.device)
    MARGIN_CE.launch("margin_ce_partial_fwd", cos_all.device, ptr(cos_all), ptr(labels),
                     k, b, c, class_offset, scale, *margin_constants(margin), ptr(parts),
                     path=margin_ce_plan(k, c)[0])
    return parts


def margin_ce_partial_grad(cos_all: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                           dloss: torch.Tensor, scale: float, margin: float,
                           class_offset: int) -> torch.Tensor:
    """K6's partial backward launch (``margin_ce_partial_bwd``): this shard's
    dcos_all from the rows' global log-sum-exp and the loss gradient."""
    k, b, c = cos_all.shape
    dcos = torch.empty_like(cos_all)
    MARGIN_CE.launch("margin_ce_partial_bwd", cos_all.device, ptr(cos_all), ptr(labels),
                     ptr(lse), ptr(dloss.float().contiguous()), k, b, c, class_offset, scale,
                     *margin_constants(margin), ptr(dcos), path=margin_ce_plan(k, c)[0])
    return dcos


class _MarginCEShardedFn(torch.autograd.Function):
    """K6's class-sharded mode: the partial forward launch, one all-reduce
    over the model group, the rows' loss, correct and global log-sum-exp;
    the backward launch with that log-sum-exp writes this shard's dcos."""

    @staticmethod
    def forward(ctx, cos_all, labels, scale, margin, class_offset, group):
        parts = margin_ce_partials(cos_all, labels, scale, margin, class_offset)
        loss, correct, lse = _all_reduce_partials(parts, labels, group)
        ctx.save_for_backward(cos_all, labels, lse)
        ctx.constants = (scale, margin, class_offset)
        ctx.mark_non_differentiable(correct)
        return loss, correct

    @staticmethod
    def backward(ctx, dloss, _dcorrect):
        cos_all, labels, lse = ctx.saved_tensors
        dcos = margin_ce_partial_grad(cos_all, labels, lse, dloss, *ctx.constants)
        return dcos, None, None, None, None, None


def margin_ce_sharded(cos_all: torch.Tensor, labels: torch.Tensor, scale: float,
                      margin: float, class_offset: int, group
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`margin_ce` of a head whose classes are split over the ranks of
    ``group``: cos_all (K, B, C) holds classes [class_offset, class_offset +
    C), labels (B,) are global. Every rank gets the rows' global loss and
    correct flags; the loss is differentiable in this shard's cos_all. K6's
    partial mode on CUDA, :func:`margin_ce_sharded_reference` on the CPU."""
    if cos_all.ndim != 3 or labels.shape != cos_all.shape[1:2]:
        raise ValueError(f"cos_all {tuple(cos_all.shape)}, labels {tuple(labels.shape)}")
    if cos_all.device.type == "cpu":
        return margin_ce_sharded_reference(cos_all, labels, scale, margin, class_offset, group)
    check_cuda("margin_ce_sharded", cos_all, (torch.float32,), 3)
    labels = labels.to(device=cos_all.device, dtype=torch.int64).contiguous()
    if labels.numel() == 0:
        raise KernelError("margin_ce_sharded: empty batch")
    return _MarginCEShardedFn.apply(cos_all, labels, float(scale), float(margin),
                                    int(class_offset), group)


class MarginProjection(nn.Module):
    """Unified margin-softmax projection. ``kernel`` is (emb, C), or (K, emb,
    C) for the sub-center kinds, float32. ``class_range`` (start, stop) makes
    it one class shard of a ``num_classes`` head split over a model group
    (``parallel/``): ``kernel`` then holds those classes only, and the
    training loss runs inside a step whose mesh has model ranks:
    ``sc_cm_linear`` in K6's class-sharded mode, the other kinds on their
    whole logits, gathered over the model group (plain torch)."""

    def __init__(self, emb_dim: int, num_classes: int, kind: str = "sc_cm_linear",
                 num_centers: int = 2, hard_margin: float = 0.1,
                 hcm_additive_margin: float = 0.1,
                 class_range: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.num_classes = num_classes
        self.class_range = (0, num_classes) if class_range is None else tuple(class_range)
        num_classes = self.class_range[1] - self.class_range[0]
        if kind not in PROJECTION_NAMES:
            raise ValueError(f"unknown projection {kind!r}")
        self.kind = kind
        self.sub_center = kind.startswith("sc_")
        self.hard_margin = hard_margin
        self.hcm_additive_margin = hcm_additive_margin
        shape = ((num_centers, emb_dim, num_classes) if self.sub_center
                 else (emb_dim, num_classes))
        self.kernel = nn.Parameter(torch.empty(shape))

    def _cos(self, embeddings: torch.Tensor, reduce_centers: bool) -> torch.Tensor:
        """Products of the normalized embeddings and kernel: (B, C), or
        (K, B, C) for sub-center kinds when ``reduce_centers`` is False."""
        emb_n = _l2_normalize(embeddings.to(self.kernel.dtype), dim=1)
        kernel_n = _l2_normalize(self.kernel, dim=0 if not self.sub_center else 1)
        if not self.sub_center:
            return emb_n @ kernel_n
        cos_all = torch.matmul(emb_n[None], kernel_n)  # einsum("bd,kdc->kbc")
        return torch.amax(cos_all, dim=0) if reduce_centers else cos_all

    def forward(self, embeddings: torch.Tensor, labels: torch.Tensor,
                scale: float = 32.0, margin: float = 0.2) -> torch.Tensor:
        """Scaled logits (B, C), float32."""
        if embeddings.ndim != 2:
            raise ValueError(f"embeddings must be (B, D), got {tuple(embeddings.shape)}")
        if self.kind == "linear":
            return embeddings.to(self.kernel.dtype) @ self.kernel
        return self._margin_logits(self._cos(embeddings, True), labels, scale, margin)

    def _margin_logits(self, cos: torch.Tensor, labels: torch.Tensor, scale: float,
                       margin: float) -> torch.Tensor:
        """The scaled logits of every kind but ``linear`` from the cosines
        (B, C) of the whole head."""
        scale = np.float32(scale)
        cos = torch.clamp(cos, -1.0, 1.0)
        label = labels.long()[:, None]
        onehot = F.one_hot(labels.long(), cos.shape[1]).to(torch.float32)
        m = np.float32(margin)
        if self.kind in ("am_linear", "sc_am_linear"):
            logits = cos - float(m) * onehot
        elif self.kind == "qm_linear":
            delta = (np.float32(1.0) - m) / np.float32(2.0)
            pos = (cos - float(np.float32(1.0) - delta)) * (float(np.float32(1.0) + delta) - cos)
            neg = (cos - float(delta)) * (cos + float(delta))
            logits = pos * onehot + neg * (1.0 - onehot)
        else:
            if self.kind in ("aam_linear", "cm_linear", "sc_cm_linear"):
                m1 = np.float32(0.5) * m * m
            elif self.kind == "cm_linear_voxsrc2020":
                m1 = m / np.float32(2.0)
            else:  # hcm_linear: fixed additive term
                m1 = np.float32(self.hcm_additive_margin)
            # the sqrt at the label column only (target_phi, with its rule
            # at |v| = 1)
            phi = target_phi(cos, label, float(np.cos(m)), float(np.sin(m)), float(m1))
            if self.kind == "hcm_linear":
                hard = (cos > phi).float()
                logits = (cos + self.hard_margin * hard).scatter(1, label, phi)
            else:
                logits = cos.scatter(1, label, phi)
        return float(scale) * logits

    def cross_entropy(self, embeddings: torch.Tensor, labels: torch.Tensor,
                      scale: float = 32.0, margin: float = 0.2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row softmax cross-entropy of the logits and the per-row 0/1
        flag argmax == label, both (B,) float32. ``sc_cm_linear`` goes through
        :func:`margin_ce` (K6 on CUDA); the other kinds through their logits."""
        group = None
        if self.class_range != (0, self.num_classes):
            mesh = active_mesh()
            if mesh is None or mesh.num_model == 1:
                raise RuntimeError("a class-sharded head runs inside a step whose mesh "
                                   "has model ranks (parallel.active)")
            group = mesh.model_group
        if self.kind == "sc_cm_linear":
            cos_all = self._cos(embeddings, False)
            if group is not None:
                return margin_ce_sharded(cos_all, labels, float(scale), float(margin),
                                         self.class_range[0], group)
            return margin_ce(cos_all, labels, float(scale), float(margin))
        if group is None:
            logits = self.forward(embeddings, labels, scale, margin)
        elif self.kind == "linear":
            logits = gather_classes(embeddings.to(self.kernel.dtype) @ self.kernel,
                                    self.class_range, self.num_classes, group)
        else:
            cos = gather_classes(self._cos(embeddings, True), self.class_range,
                                 self.num_classes, group)
            logits = self._margin_logits(cos, labels, scale, margin)
        loss = F.cross_entropy(logits, labels.long(), reduction="none")
        return loss, (logits.argmax(dim=1) == labels).float()
