"""PyTorch port, training modules: each against the JAX package on the CPU in
float32, with the same numpy inputs (the CUDA kernels themselves are in
tests/test_torch_kernels.py).

Tolerances: rtol = atol = 1e-4 for every output, running statistic and
gradient (tests/test_models.py:87), except the schedules (float32 scalars on
both sides, rtol 1e-6), the margin heads' logits at scale 32 (atol 1e-4 *
scale), and the thin Res2Net's parameter gradients, which go through eleven
training BNs and are held to 2e-4 of each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.losses import MarginProjection as JaxProjection
from voxsrc2020_speaker_verification_tpu.losses import schedules as jsched
from voxsrc2020_speaker_verification_tpu.models import get_model as jax_get_model
from voxsrc2020_speaker_verification_tpu.models import register_res2net_variant as jax_register
from voxsrc2020_speaker_verification_tpu.ops import nn as jops
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax
from voxsrc2020_speaker_verification_tpu_torch.losses import schedules as tsched
from voxsrc2020_speaker_verification_tpu_torch.losses.projections import (
    PROJECTION_NAMES, MarginProjection, margin_ce, margin_ce_reference)
from voxsrc2020_speaker_verification_tpu_torch.models import (
    get_model, register_res2net_variant)
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as tops

TOL = dict(rtol=1e-4, atol=1e-4)


def assert_rel(got, want, tol, msg=""):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"{msg}: relative error {err} > {tol}"

# thin Res2Net: two stride-1 blocks (split chain, projection in the first)
# and one stride-2 block, widths 4 and 8, split 4
# one torch thread: the suite runs in parallel workers beside JAX tests
# whose 8-device CPU collectives abort when starved of cores
torch.set_num_threads(1)

THIN = "res2net50_thin_torch_train"
THIN_KW = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
               width=(4, 8), split=4, output_dim=16)
jax_register(THIN, **THIN_KW)
register_res2net_variant(THIN, **THIN_KW)


def to_port(x_nhwc):
    t = torch.from_numpy(np.ascontiguousarray(x_nhwc, np.float32))
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def to_nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def jax_bn_train(x, stats, groups, cot):
    """JAX training BN: output, mutated stats and the input gradient."""
    bn = jops.BatchNorm()
    variables = {"batch_stats": {"bn": {"mean": jnp.asarray(stats[0]),
                                        "var": jnp.asarray(stats[1])}}}

    def f(x):
        with jops.bn_groups(groups):
            return bn.apply(variables, x, mutable=["batch_stats"])

    y, vjp, mut = jax.vjp(f, jnp.asarray(x), has_aux=True)
    st = mut["batch_stats"]["bn"]
    return np.asarray(y), np.asarray(st["mean"]), np.asarray(st["var"]), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("shape,groups", [((4, 5, 3, 8), 1), ((4, 5, 3, 8), 2),
                                          ((6, 12), 1), ((6, 12), 2)])
def test_training_bn_matches_jax(shape, groups):
    """K5's plain version: output, running mean/var (Bessel on 4-D only)
    and the input gradient against ops.BatchNorm under bn_groups(g)."""
    rng = np.random.RandomState(sum(shape) + groups)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    stats = (rng.randn(c).astype(np.float32) * 0.3, rng.uniform(0.5, 2, c).astype(np.float32))
    cot = rng.randn(*shape).astype(np.float32)
    want_y, want_m, want_v, want_dx = jax_bn_train(x, stats, groups, cot)

    xt = to_port(x).requires_grad_(True)
    rm, rv = torch.from_numpy(stats[0].copy()), torch.from_numpy(stats[1].copy())
    bn = tops.BatchNorm(c, groups=groups)
    bn.running_mean.copy_(rm)
    bn.running_var.copy_(rv)
    y = bn(xt, True)
    y.backward(to_port(cot))
    np.testing.assert_allclose(to_nhwc(y), want_y, **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_m, **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), want_v, **TOL)
    np.testing.assert_allclose(to_nhwc(xt.grad), want_dx, **TOL)


@pytest.mark.parametrize("mode", ["relu", "raw_shortcut", "bn_shortcut"])
def test_training_bn_epilogue_matches_jax(mode):
    """relu(BN(x) [+ s | + BN_s(s)]) with two groups, as bn1 / bn3 compose
    it in the JAX model (models/res2net.py:127-151), forward and gradients
    of x and s; the projection BN's running statistics update too."""
    rng = np.random.RandomState(7)
    shape, c = (4, 6, 3, 8), 8
    x, s = (rng.randn(2, *shape) * 1.5).astype(np.float32)
    st = [(rng.randn(c).astype(np.float32) * 0.3, rng.uniform(0.5, 2, c).astype(np.float32))
          for _ in range(2)]
    cot = rng.randn(*shape).astype(np.float32)
    bn, bn_s = jops.BatchNorm(), jops.BatchNorm()
    vx = {"batch_stats": {"bn": {"mean": st[0][0], "var": st[0][1]}}}
    vs = {"batch_stats": {"bn": {"mean": st[1][0], "var": st[1][1]}}}

    def f(x, s):
        with jops.bn_groups(2):
            y, mx = bn.apply(vx, x, mutable=["batch_stats"])
            ms = vs
            if mode == "raw_shortcut":
                y = y + s
            elif mode == "bn_shortcut":
                ys, ms = bn_s.apply(vs, s, mutable=["batch_stats"])
                y = y + ys
            return jax.nn.relu(y), (mx, ms)

    y, vjp, (mx, ms) = jax.vjp(f, jnp.asarray(x), jnp.asarray(s), has_aux=True)
    dx, ds = vjp(jnp.asarray(cot))

    xt, sc = to_port(x).requires_grad_(True), to_port(s).requires_grad_(True)
    b1, b2 = tops.BatchNorm(c, groups=2), tops.BatchNorm(c, groups=2)
    for b, (m, v) in ((b1, st[0]), (b2, st[1])):
        b.running_mean.copy_(torch.from_numpy(m))
        b.running_var.copy_(torch.from_numpy(v))
    got = b1(xt, True, relu=True, shortcut=None if mode == "relu" else sc,
             shortcut_bn=b2 if mode == "bn_shortcut" else None)
    got.backward(to_port(cot))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(y), **TOL)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(dx), **TOL)
    if mode != "relu":
        np.testing.assert_allclose(to_nhwc(sc.grad), np.asarray(ds), **TOL)
    for b, mut in ((b1, mx), (b2, ms)):
        np.testing.assert_allclose(b.running_mean.numpy(),
                                   np.asarray(mut["batch_stats"]["bn"]["mean"]), **TOL)
        np.testing.assert_allclose(b.running_var.numpy(),
                                   np.asarray(mut["batch_stats"]["bn"]["var"]), **TOL)


# masked: False (no mask), True (lengths 13, 6, 0: one row fully masked) or
# the case: NHWC (B, T, W, C) and the mask kind; long T is the kernel's
# column design (past its 128-row ring), ragged C no multiple of its 16-byte
# vectors
POOL_CASES = {False: ((3, 13, 5, 8), None), True: ((3, 13, 5, 8), "lengths"),
              "interior_zeros": ((4, 13, 5, 8), "interior"),
              "weights": ((3, 13, 5, 8), "weights"),
              "long_t": ((2, 1200, 3, 8), "lengths"),
              "ragged_c": ((3, 37, 5, 20), "interior"),
              "w1_long_t": ((2, 1000, 1, 24), "lengths")}


@pytest.mark.parametrize("masked", list(POOL_CASES))
def test_stats_pool_backward_matches_jax(masked):
    """K4b's plain version (autograd of the plain stats pool) against
    jax.vjp(stats_pool), without a mask, with lengths (one row fully
    masked), interior zeros (one row fully masked), weights, long T,
    ragged C and W = 1 at an extraction bucket's 1000 frames."""
    (b, t, w, c), kind = POOL_CASES[masked]
    rng = np.random.RandomState(11)
    x = (rng.randn(b, t, w, c) * 2 + 1).astype(np.float32)
    mask = None
    if kind == "lengths":
        lens = np.array([t, t // 2, 0])[:b]
        mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    elif kind == "interior":
        mask = (rng.rand(b, t) > 0.3).astype(np.float32)
        mask[1] = 0.0
    elif kind == "weights":
        mask = rng.rand(b, t).astype(np.float32)
    cot = rng.randn(b, 1, w, 2 * c).astype(np.float32)
    want_y, vjp = jax.vjp(lambda x: jops.stats_pool(x, None if mask is None else jnp.asarray(mask)),
                          jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    xt = to_port(x).requires_grad_(True)
    y = tops.stats_pool(xt, None if mask is None else torch.from_numpy(mask))
    y.backward(to_port(cot))
    np.testing.assert_allclose(to_nhwc(y), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(to_nhwc(xt.grad), want, **TOL)


def projection_case(kind, seed=3, b=6, d=8, classes=11, centers=2):
    rng = np.random.RandomState(seed)
    emb = rng.randn(b, d).astype(np.float32)
    labels = rng.randint(0, classes, b).astype(np.int32)
    jproj = JaxProjection(num_classes=classes, kind=kind, num_centers=centers)
    params = jproj.init(jax.random.PRNGKey(seed), jnp.asarray(emb), jnp.asarray(labels))
    kernel = np.asarray(params["params"]["kernel"])
    port = MarginProjection(d, classes, kind, centers)
    port.kernel.data.copy_(torch.from_numpy(kernel))
    return jproj, params, port, emb, labels


@pytest.mark.parametrize("kind", PROJECTION_NAMES)
def test_projection_logits_match_jax(kind):
    jproj, params, port, emb, labels = projection_case(kind)
    want = np.asarray(jproj.apply(params, jnp.asarray(emb), jnp.asarray(labels), 32.0, 0.25))
    got = port(torch.from_numpy(emb), torch.from_numpy(labels), 32.0, 0.25)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=32e-4)


@pytest.mark.parametrize("kind", ["sc_cm_linear", "aam_linear"])
def test_projection_cross_entropy_and_grads_match_jax(kind):
    """The training loss (mean CE over the batch) and its gradient with
    respect to the embeddings and the kernel; sc_cm_linear goes through
    margin_ce (K6's plain version on the CPU)."""
    jproj, params, port, emb, labels = projection_case(kind, seed=5)

    def loss_fn(p, e):
        logits = jproj.apply(p, e, jnp.asarray(labels), 32.0, 0.3)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return ce.mean(), jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))

    (want, want_acc), (gp, ge) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(emb))
    et = torch.from_numpy(emb).requires_grad_(True)
    rows, correct = port.cross_entropy(et, torch.from_numpy(labels), 32.0, 0.3)
    rows.mean().backward()
    np.testing.assert_allclose(float(rows.mean().detach()), float(want), **TOL)
    assert float(correct.mean()) == float(want_acc)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge), **TOL)
    np.testing.assert_allclose(port.kernel.grad.numpy(), np.asarray(gp["params"]["kernel"]), **TOL)


def test_margin_ce_plain_path_is_the_reference_on_cpu():
    rng = np.random.RandomState(9)
    cos = torch.from_numpy(rng.uniform(-0.99, 0.99, (2, 5, 13)).astype(np.float32))
    cos[1, 0, 3] = cos[0, 0, 3]  # a tie between centers
    labels = torch.from_numpy(rng.randint(0, 13, 5))
    a = margin_ce(cos, labels, 32.0, 0.2)
    b = margin_ce_reference(cos, labels, 32.0, 0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_margin_ce_matches_jax_at_the_training_width():
    """margin_ce (K6's plain version on the CPU) against the JAX package's
    sc_cm_linear head + softmax CE and their gradients, at K = 2 centers,
    B = 8 and the training head's 5994 classes, with a tie between the
    centers at row 0's label and a cosine that rounds above 1 (the clip
    active) in row 1: loss and accuracy, and every gradient within 1e-4
    where JAX's is finite. At the clipped cosine JAX's gradient is NaN (its
    sqrt(1 - cos^2) branch, masked out by the one-hot, still gives 0 * inf)
    on the clipped row's embedding and in the column's kernel; the port's is
    finite there (margin_ce gives a clipped element a zero gradient). The
    JAX side is jitted, as the trainer runs it."""
    rng = np.random.RandomState(11)
    b, d, c = 8, 16, 5994
    emb = rng.randn(b, d).astype(np.float32)
    labels = rng.randint(0, c, b).astype(np.int32)
    jproj = JaxProjection(num_classes=c, kind="sc_cm_linear", num_centers=2)
    kernel = rng.randn(2, d, c).astype(np.float32)
    kernel[1, :, labels[0]] = kernel[0, :, labels[0]]
    c0 = (labels[1] + 1) % c
    emb[1] = np.random.RandomState(6).randn(d).astype(np.float32)
    kernel[0, :, c0] = emb[1] * 0.5
    kernel[1, :, c0] = -emb[1]
    params = {"params": {"kernel": jnp.asarray(kernel)}}
    port = MarginProjection(d, c, "sc_cm_linear", 2)
    port.kernel.data.copy_(torch.from_numpy(kernel))
    cos_all = port._cos(torch.from_numpy(emb), False).detach()
    assert cos_all[0, 0, labels[0]] == cos_all[1, 0, labels[0]] and cos_all[0, 1, c0] > 1

    def loss_fn(p, e):
        logits = jproj.apply(p, e, jnp.asarray(labels), 32.0, 0.2)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels))
        return ce.mean(), logits

    (want, logits), (gp, ge) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(emb))
    assert float(logits[1, c0]) == 32.0  # JAX clips it too
    et = torch.from_numpy(emb).requires_grad_(True)
    rows, correct = port.cross_entropy(et, torch.from_numpy(labels), 32.0, 0.2)
    rows.mean().backward()
    np.testing.assert_allclose(float(rows.mean().detach()), float(want), **TOL)
    want_acc = np.mean(np.argmax(np.asarray(logits), -1) == labels)
    assert float(correct.mean()) == float(want_acc)
    ge, gk = np.asarray(ge), np.asarray(gp["params"]["kernel"])
    got_e, got_k = et.grad.numpy(), port.kernel.grad.numpy()
    near_e, near_k = np.zeros(ge.shape, bool), np.zeros(gk.shape, bool)
    near_e[1], near_k[:, :, c0] = True, True
    nan_e, nan_k = np.isnan(ge), np.isnan(gk)
    assert nan_e.any() and not (nan_e & ~near_e).any() and not (nan_k & ~near_k).any()
    assert np.isfinite(got_e).all() and np.isfinite(got_k).all()
    np.testing.assert_allclose(got_e[~nan_e], ge[~nan_e], **TOL)
    np.testing.assert_allclose(got_k[~nan_k], gk[~nan_k], **TOL)


def margin_formula64(cos_all, labels, scale, margin):
    """The sub-center margin CE as the JAX package writes it (sqrt(1 - v^2)
    on every column, the one-hot picking the label's), in float64."""
    m = torch.tensor(margin, dtype=torch.float64)
    v = torch.clamp(torch.amax(cos_all, dim=0), -1.0, 1.0)
    onehot = torch.nn.functional.one_hot(labels.long(), v.shape[1]).double()
    sin = torch.sqrt(torch.clamp(1.0 - v * v, min=0.0))
    phi = v * torch.cos(m) - sin * torch.sin(m) - 0.5 * m * m
    logits = scale * (phi * onehot + v * (1.0 - onehot))
    return torch.logsumexp(logits, 1) - logits.gather(1, labels.long()[:, None])[:, 0]


@pytest.mark.parametrize("at_label", [True, False], ids=["label", "non_label"])
@pytest.mark.parametrize("value", [1.0, -1.0], ids=["plus1", "minus1"])
def test_margin_ce_reference_at_unit_cosines(at_label, value):
    """A cosine of exactly +1 or -1 (every center) at a label or a non-label
    column: the loss and dcos_all are finite, and equal float64 autograd of
    the JAX package's formula wherever that is finite (1e-4). The sqrt is
    taken at the label column only, so a non-label column keeps its softmax
    gradient; at a label with |v| = 1 the gradient is zero by rule."""
    rng = np.random.RandomState(12)
    cos = rng.uniform(-0.9, 0.9, (2, 4, 13)).astype(np.float32)
    labels = np.array([3, 5, 7, 9])
    col = labels[1] if at_label else (labels[1] + 1) % 13
    cos[:, 1, col] = value
    dloss = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    ci = torch.from_numpy(cos).requires_grad_(True)
    loss, _ = margin_ce_reference(ci, torch.from_numpy(labels), 32.0, 0.2)
    loss.backward(torch.from_numpy(dloss))
    c64 = torch.from_numpy(cos).double().requires_grad_(True)
    want = margin_formula64(c64, torch.from_numpy(labels), 32.0, 0.2)
    want.backward(torch.from_numpy(dloss).double())
    got_d, want_d = ci.grad.numpy(), c64.grad.numpy()
    assert np.isfinite(loss.detach().numpy()).all() and np.isfinite(got_d).all()
    np.testing.assert_allclose(loss.detach().numpy(), want.detach().numpy(), **TOL)
    ok = np.isfinite(want_d)
    assert ok[:, 0].all() and ok[:, 2:].all()  # the other rows are finite in float64
    np.testing.assert_allclose(got_d[ok], want_d[ok], **TOL)
    if at_label:
        assert (got_d[:, 1, col] == 0).all()
    else:
        assert not ok[:, 1, col].any() and (got_d[:, 1, col] != 0).all()


@pytest.mark.parametrize("kind", ["sc_cm_linear", "cm_linear"])
def test_projection_at_unit_cosines_matches_jax(kind):
    """Embeddings and kernel columns built so that the normalized products
    are exactly +1 and -1, at a label (rows 0 and 1) and at a non-label
    column (rows 2 and 3): the port's loss equals the JAX head + CE (1e-4),
    its embedding and kernel gradients are finite everywhere and equal
    JAX's at 1e-4 wherever JAX's are finite (JAX is NaN on those rows and
    columns, ROADMAP.md §3)."""
    b, d, c = 4, 8, 11
    rng = np.random.RandomState(13)
    emb = np.eye(d, dtype=np.float32)[:b] * np.array([[2.0], [1.5], [3.0], [0.5]], np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    sub = kind.startswith("sc_")
    kernel = rng.randn(*((2, d, c) if sub else (d, c))).astype(np.float32) * 0.1
    kernel[..., 4:, :] = rng.randn(*kernel[..., 4:, :].shape).astype(np.float32)
    units = {(0, 0): 2.0, (1, 1): -3.0, (2, 5): 4.0, (3, 6): -0.5}  # (row, column): scale
    for (row, col), k in units.items():
        kernel[..., :, col] = 0.0
        kernel[..., row, col] = k
        if sub and k > 0:
            kernel[1, :, col] = rng.randn(d) * 0.1  # center 1 below center 0's +1
            kernel[1, row, col] = 0.0
    jproj = JaxProjection(num_classes=c, kind=kind, num_centers=2)
    port = MarginProjection(d, c, kind, 2)
    port.kernel.data.copy_(torch.from_numpy(kernel))
    cos = port._cos(torch.from_numpy(emb), True).detach().numpy()
    for (row, col), k in units.items():
        assert cos[row, col] == np.sign(k), (row, col, cos[row, col])

    def loss_fn(p, e):
        logits = jproj.apply(p, e, jnp.asarray(labels), 32.0, 0.2)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    want, (gp, ge) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(emb))
    et = torch.from_numpy(emb).requires_grad_(True)
    rows, _ = port.cross_entropy(et, torch.from_numpy(labels), 32.0, 0.2)
    rows.mean().backward()
    np.testing.assert_allclose(float(rows.mean().detach()), float(want), **TOL)
    got_e, got_k = et.grad.numpy(), port.kernel.grad.numpy()
    ge, gk = np.asarray(ge), np.asarray(gp["params"]["kernel"])
    assert np.isfinite(got_e).all() and np.isfinite(got_k).all()
    assert not np.isfinite(ge).all()
    np.testing.assert_allclose(got_e[np.isfinite(ge)], ge[np.isfinite(ge)], **TOL)
    np.testing.assert_allclose(got_k[np.isfinite(gk)], gk[np.isfinite(gk)], **TOL)


def schedule_steps(bounds):
    return sorted({max(0, s) for b in bounds for s in (b - 1, b, b + 1)} | {0, 5})


@pytest.mark.parametrize("kind", ["exp", "cosine", "margin"])
def test_schedules_match_jax_around_every_boundary(kind):
    epoch = 37
    lr_bounds, m_bounds = [3 * epoch, 13 * epoch, 23 * epoch], [3 * epoch, 13 * epoch]
    steps = schedule_steps(lr_bounds + [13 * epoch + 2 * epoch] + m_bounds) + [40 * epoch]
    for s in steps:
        if kind == "exp":
            want = jsched.warmup_constant_exponential_decay(0.64, s, lr_bounds, epoch)
            got = tsched.warmup_constant_exponential_decay(0.64, s, lr_bounds, epoch)
        elif kind == "cosine":
            want = jsched.warmup_constant_cosine_decay(0.64, s, lr_bounds)
            got = tsched.warmup_constant_cosine_decay(0.64, s, lr_bounds)
        else:
            want = jsched.zero_linear_constant(0.2, s, m_bounds, epoch)
            got = tsched.zero_linear_constant(0.2, s, m_bounds, epoch)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, err_msg=f"step {s}")
    for pid in ("sc_cm_linear", "cm_linear_voxsrc2020", "am_linear"):
        np.testing.assert_allclose(tsched.total_margin(pid, 0.15),
                                   np.asarray(jsched.total_margin(pid, jnp.float32(0.15))),
                                   rtol=1e-6)


def test_thin_res2net_training_forward_backward_matches_jax():
    """The encoder in training mode with two BN groups: embeddings, the
    mutated running statistics and every parameter gradient. Four rows per
    group: with two, the head BN's output is +-1 whatever its input, and its
    gradient is rounding noise on both sides."""
    rng = np.random.RandomState(13)
    x = rng.randn(8, 24, 16).astype(np.float32)
    cot = rng.randn(8, 16).astype(np.float32)
    model = jax_get_model(THIN)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 24, 16)), False)
    params = jax.device_get(variables["params"])
    stats = jax.tree.map(lambda v: np.asarray(v) + 0.25, jax.device_get(variables["batch_stats"]))

    def f(p):
        with jops.bn_groups(2):
            return model.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True,
                               mutable=["batch_stats"])

    # one jitted program: op-by-op dispatch of the whole backward took ~30 s
    # of CPU beside the JAX package's multi-device tests
    @jax.jit
    def forward_backward(p):
        emb, vjp, mut = jax.vjp(f, p, has_aux=True)
        return emb, vjp(jnp.asarray(cot))[0], mut

    emb, grads, mut = forward_backward(params)

    port = get_model(THIN, feat_dim=16)
    port.set_bn_groups(2)
    port.load_state_dict(from_flax({"params": params, "batch_stats": stats}))
    got = port(torch.from_numpy(x), True)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(emb), **TOL)
    want_stats = from_flax({"batch_stats": jax.device_get(mut["batch_stats"])})
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), err_msg=k, **TOL)
    want_grads = from_flax({"params": jax.device_get(grads)})
    named = dict(port.named_parameters())
    assert set(named) == set(want_grads)
    for k, p in named.items():
        assert_rel(p.grad.numpy(), want_grads[k].numpy(), 2e-4, k)
