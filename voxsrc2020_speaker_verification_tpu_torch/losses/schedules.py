"""Step-keyed LR and margin schedules, in float32.

The same piecewise functions as the JAX package's ``losses/schedules.py``,
computed on the host with numpy float32 scalars at the points where the JAX
package computes in float32, so the training step needs no device round
trip for them. Everything is keyed on the global optimizer step, which keeps
the LMFT resume contract: a restored step past the last LR boundary lands in
the 1/128 tail.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

f32 = np.float32


def warmup_constant_exponential_decay(
    learning_rate: float,
    step: int,
    boundaries: Sequence[int],
    decay_steps: int,
    decay_rate: float = 0.5,
    staircase: bool = True,
) -> np.float32:
    """Linear warmup <= b0; constant (b0, b1]; decay_rate^ceil((s-b1)/decay)
    on (b1, b2]; fixed 1/128 tail past b2."""
    if len(boundaries) != 3:
        raise ValueError(f"three boundaries, got {boundaries}")
    s = f32(step)
    b0, b1, b2 = (f32(b) for b in boundaries)
    lr = f32(learning_rate)
    if s > b2:
        return lr * f32(1.0 / 128.0)
    if s > b1:
        p = (s - b1) / f32(decay_steps)
        if staircase:
            p = np.ceil(p)
        return lr * f32(decay_rate) ** p
    return lr * (s / b0) if s <= b0 else lr


def warmup_constant_cosine_decay(
    learning_rate: float,
    step: int,
    boundaries: Sequence[int],
) -> np.float32:
    """Cosine variant: linear warmup, constant, half-cosine on (b1, b2],
    1/128 tail."""
    if len(boundaries) != 3:
        raise ValueError(f"three boundaries, got {boundaries}")
    s = f32(step)
    b0, b1, b2 = (f32(b) for b in boundaries)
    lr = f32(learning_rate)
    if s > b2:
        return lr * f32(1.0 / 128.0)
    if s > b1:
        p = (s - b1) / (b2 - b1)
        return lr * f32(0.5) * (f32(1.0) + np.cos(p * f32(math.pi)))
    return lr * (s / b0) if s <= b0 else lr


def zero_linear_constant(
    margin: float,
    step: int,
    boundaries: Sequence[int],
    grow_steps: int,
    staircase: bool = True,
) -> np.float32:
    """0 until b0; staircase-linear growth to ``margin`` on (b0, b1];
    constant after."""
    if len(boundaries) != 2:
        raise ValueError(f"two boundaries, got {boundaries}")
    s = f32(step)
    b0, b1 = (f32(b) for b in boundaries)
    m = f32(margin)
    if s <= b0:
        return f32(0.0)
    if s > b1:
        return m
    p = (s - b0) / f32(grow_steps)
    if staircase:
        p = np.ceil(p)
    return m * (p * f32(grow_steps)) / (b1 - b0)


def total_margin(projection_id: str, margin) -> np.float32:
    """Reported margin including the additive term."""
    m = f32(margin)
    if projection_id in ("linear", "am_linear", "sc_am_linear"):
        return m + f32(0.0)
    if projection_id in ("aam_linear", "cm_linear", "sc_cm_linear", "hcm_linear"):
        return m + f32(0.5) * m * m
    if projection_id == "cm_linear_voxsrc2020":
        return m + f32(0.5) * m
    raise ValueError(projection_id)


def base_learning_rate(world_batch: int) -> float:
    """Reference LR scaling: 0.08/128 * effective global batch."""
    return 0.08 / 128.0 * world_batch
