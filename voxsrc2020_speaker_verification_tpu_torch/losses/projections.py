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
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import MARGIN_CE, KernelError, check_cuda, ptr

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
                         k, b, c, scale, *consts, ptr(out[0]), ptr(out[1]), ptr(out[2]),
                         path=path)
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


class MarginProjection(nn.Module):
    """Unified margin-softmax projection. ``kernel`` is (emb, C), or (K, emb,
    C) for the sub-center kinds, float32."""

    def __init__(self, emb_dim: int, num_classes: int, kind: str = "sc_cm_linear",
                 num_centers: int = 2, hard_margin: float = 0.1,
                 hcm_additive_margin: float = 0.1):
        super().__init__()
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
        scale = np.float32(scale)
        if self.kind == "linear":
            return embeddings.to(self.kernel.dtype) @ self.kernel
        cos = torch.clamp(self._cos(embeddings, True), -1.0, 1.0)
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
        if self.kind == "sc_cm_linear":
            return margin_ce(self._cos(embeddings, False), labels, float(scale),
                             float(margin))
        logits = self.forward(embeddings, labels, scale, margin)
        loss = F.cross_entropy(logits, labels.long(), reduction="none")
        return loss, (logits.argmax(dim=1) == labels).float()
