"""PyTorch port, attentive statistics pooling on the CPU against the JAX
package: ``ops.att_pool_reference`` (the plain version of K8 / K8b) against
a line-for-line transcription of the JAX ``AttStatsPool`` after its
``att_conv2`` (voxsrc2020_speaker_verification_tpu/ops/nn.py:530-539),
forward and ``jax.vjp``; and the whole ``ops.AttStatsPool`` module against
the JAX module, forward and gradients of x and of both 1x1 convs.

Edges: a row masked throughout (uniform weights over all T frames, not
0/0), a row of constant x with constant scores at T = 8, where q - mean^2
is exactly 0 (``jnp.maximum``'s tie, at which the variance's gradient
vanishes anyway), T = 1, and bf16.
Tolerances: float32 1e-4 (rtol and atol); bf16 inputs 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.ops import nn as jops
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as tops

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_att_tail(x, scores, mask):
    """JAX ops/nn.py:530-539 on NHWC x and scores, mask (B, T) or None."""
    x32 = x.astype(jnp.float32)
    scores = scores.astype(jnp.float32)
    if mask is not None:
        m = mask.astype(jnp.float32)[:, :, None, None]
        scores = jnp.where(m > 0, scores, -1e30)
    weights = jax.nn.softmax(scores, axis=1)
    wmean = jnp.sum(x32 * weights, axis=1, keepdims=True)
    wsq = jnp.sum(x32 * x32 * weights, axis=1, keepdims=True)
    wstd = jnp.sqrt(jnp.maximum(wsq - wmean * wmean, 0.0) + jops.POOL_EPSILON)
    return jnp.concatenate([wmean, wstd], axis=3).astype(x.dtype)


def to_port(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def case(name):
    """(x, scores, mask) NHWC float32 for one named case."""
    rng = np.random.RandomState(len(name))
    b, t, w, c = {"masked": (3, 11, 2, 6), "fully_masked": (3, 11, 2, 6),
                  "tie": (2, 8, 1, 4), "t1": (2, 1, 3, 20), "bf16": (3, 11, 2, 6)}[name]
    x = (rng.randn(b, t, w, c) * 2 + 0.5).astype(np.float32)
    s = (rng.randn(b, t, w, c) * 3).astype(np.float32)
    lens = {"masked": [11, 5, 1], "fully_masked": [11, 0, 3], "tie": [8, 8],
            "t1": None, "bf16": [11, 6, 2]}[name]
    mask = None if lens is None else (np.arange(t)[None] < np.array(lens)[:, None]).astype(np.float32)
    if mask is not None:
        x *= mask[:, :, None, None]
    if name == "tie":  # row 0: constant x and scores, exact sums
        x[0] = 2.0
        s[0] = 0.75
    return x, s, mask


@pytest.mark.parametrize("name", ["masked", "fully_masked", "tie", "t1", "bf16"])
def test_att_pool_reference_matches_jax(name):
    x, s, mask = case(name)
    dtype = jnp.bfloat16 if name == "bf16" else jnp.float32
    tdtype = torch.bfloat16 if name == "bf16" else torch.float32
    jx, js = jnp.asarray(x, dtype), jnp.asarray(s, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda a, b: jax_att_tail(a, b, jm), jx, js)
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    wdx, wds = vjp(jnp.asarray(cot, dtype))
    px = to_port(np.asarray(jx.astype(jnp.float32))).to(tdtype).requires_grad_(True)
    ps = to_port(np.asarray(js.astype(jnp.float32))).to(tdtype).requires_grad_(True)
    got = tops.att_pool_reference(px, ps, None if mask is None else torch.from_numpy(mask))
    got.backward(to_port(cot).to(tdtype))
    tol = dict(rtol=2e-2, atol=2e-2) if name == "bf16" else TOL
    for g, w in ((got, want), (px.grad, wdx), (ps.grad, wds)):
        w = np.asarray(w.astype(jnp.float32))
        # bf16 gradients relative to their largest magnitude
        scale = max(np.abs(w).max(), 1.0) if name == "bf16" else 1.0
        np.testing.assert_allclose(to_nhwc(g) / scale, w / scale, **tol)
    if name == "fully_masked":  # uniform weights: the plain mean of the row
        np.testing.assert_allclose(to_nhwc(got)[1, 0, :, :6], x[1].mean(0), **TOL)
        assert np.all(to_nhwc(ps.grad)[1] == 0)
    if name == "tie":
        # q - mean^2 == 0 exactly, where jnp.maximum passes half the
        # gradient; the variance's own gradient vanishes at a constant row,
        # so dx = d mean / T and ds = 0 (to rounding) whatever share passes
        g = to_nhwc(px.grad)[0]
        np.testing.assert_allclose(g, np.broadcast_to(cot[0, 0, 0, :4] / 8, g.shape), **TOL)
        np.testing.assert_allclose(to_nhwc(ps.grad)[0], 0.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_att_stats_pool_module_matches_jax(bf16):
    """The module on a masked batch (one row masked throughout): [x; mean;
    std] through att_conv1 (split as W[:, :C] x + W[:, C:] [mean; std] in
    the port), tanh, att_conv2, the pooling; forward and the gradients of
    x and of both convs' weights."""
    rng = np.random.RandomState(3)
    b, t, w, c = 3, 9, 2, 8
    mask = (np.arange(t)[None] < np.array([9, 4, 0])[:, None]).astype(np.float32)
    x = (rng.randn(b, t, w, c) * mask[:, :, None, None]).astype(np.float32)
    dtype = jnp.bfloat16 if bf16 else None
    jmod = jops.AttStatsPool(att_dim=6, dtype=dtype)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)

    def f(params, a):
        return jmod.apply({"params": params}, a, jnp.asarray(mask)).astype(jnp.float32)

    want, vjp = jax.vjp(f, variables["params"], jx)
    cot = rng.randn(*want.shape).astype(np.float32)
    dparams, dx = vjp(jnp.asarray(cot))
    port = tops.AttStatsPool(c, att_dim=6)
    port.load_state_dict(from_flax(variables))
    px = to_port(np.asarray(jx.astype(jnp.float32)))
    px = px.to(torch.bfloat16 if bf16 else torch.float32).requires_grad_(True)
    got = port(px, torch.from_numpy(mask))
    got.float().backward(to_port(cot))
    flat = from_flax({"params": dparams})
    pairs = [(to_nhwc(got), np.asarray(want)), (to_nhwc(px.grad), np.asarray(dx, np.float32))]
    pairs += [(port.state_dict(keep_vars=True)[k].grad.numpy(), v.numpy()) for k, v in flat.items()]
    for g, w_ in pairs:
        if bf16:  # relative to each tensor's largest magnitude
            scale = max(np.abs(w_).max(), 1e-3)
            np.testing.assert_allclose(g / scale, w_ / scale, rtol=0, atol=2e-2)
        else:
            np.testing.assert_allclose(g, w_, **TOL)
