"""PyTorch port, ops layer: each primitive against the JAX package's on the
CPU in float32, with the same numpy inputs (the CUDA kernels themselves are
in tests/test_torch_kernels.py).

Tolerances: fbank 1e-3 abs in log-mel (both sides are float32 matmul
paths; JAX at HIGHEST precision); every other primitive rtol = atol = 1e-4,
as tests/test_models.py uses for the masked forward.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.data.dataset import sliding_cmn_np as jax_cmn
from voxsrc2020_speaker_verification_tpu.ops import fbank as jfb
from voxsrc2020_speaker_verification_tpu.ops import nn as jops
from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np as port_cmn
from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as tfb
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def to_port(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (the same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc, np.float32)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def bn_stats(rng, c):
    return (rng.randn(c).astype(np.float32) * 0.3,
            rng.uniform(0.5, 2.0, c).astype(np.float32))


def jax_bn_eval(x, mean, var):
    bn = jops.BatchNorm(use_running_average=True)
    return bn.apply({"batch_stats": {"bn": {"mean": jnp.asarray(mean),
                                            "var": jnp.asarray(var)}}}, jnp.asarray(x))


def lengths_mask(rng, b, t):
    lens = rng.randint(1, t + 1, b)
    lens[0] = t
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports with neither JAX
    nor the JAX package: the GPU machine has neither."""
    code = """
import importlib, pkgutil, sys
import voxsrc2020_speaker_verification_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "ml_dtypes")
       or m == "voxsrc2020_speaker_verification_tpu"
       or m.startswith("voxsrc2020_speaker_verification_tpu.")]
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith(pkg.__name__)]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 15  # every module of the slice


@pytest.mark.parametrize("num_bins", [80, 40])
def test_fbank_matches_jax(num_bins):
    rng = np.random.RandomState(num_bins)
    waves = jfb.pcm16(rng.randn(2, 21040) * 3000).astype(np.float32)
    want = np.asarray(jfb.fbank(jnp.asarray(waves), jfb.FbankConfig(num_bins=num_bins, dither=0.0)))
    cfg = tfb.FbankConfig(num_bins=num_bins, dither=0.0)
    got = tfb.fbank(torch.from_numpy(waves), cfg).numpy()
    assert got.shape == want.shape == (2, tfb.num_frames(21040, cfg), num_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # a 1-D wave is one utterance
    one = tfb.fbank(torch.from_numpy(waves[1]), cfg).numpy()
    np.testing.assert_allclose(one, got[1], rtol=0, atol=1e-6)


def test_fbank_constants_match_jax():
    for bins in (80, 40):
        a = jfb.analysis_matrices(jfb.FbankConfig(num_bins=bins))
        b = tfb.analysis_matrices(tfb.FbankConfig(num_bins=bins))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert tfb.num_frames(399, tfb.FbankConfig()) == 0
    assert tfb.fbank(torch.zeros(300), tfb.FbankConfig(dither=0.0)).shape == (0, 80)


def test_fbank_rejects_dither():
    with pytest.raises(ValueError, match="dither"):
        tfb.fbank(torch.zeros(1, 1600), tfb.FbankConfig(dither=1.0))


def test_sliding_cmn_matches_jax():
    rng = np.random.RandomState(3)
    for t in (7, 300, 1301):
        f = rng.randn(t, 40).astype(np.float32) * 4 + 2
        np.testing.assert_array_equal(port_cmn(f, 300), jax_cmn(f, 300))


@pytest.mark.parametrize("masked", [False, True])
def test_stats_pool_matches_jax(masked):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 13, 5, 8).astype(np.float32) * 2 + 1
    mask = lengths_mask(rng, 3, 13) if masked else None
    want = np.asarray(jops.stats_pool(jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
    got = tops.stats_pool(to_port(x), None if mask is None else torch.from_numpy(mask))
    assert got.shape == (3, 16, 1, 5) and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shortcut", ["none", "raw", "bn"])
@pytest.mark.parametrize("masked", [False, True])
def test_bn_act_matches_jax(relu, shortcut, masked):
    """Eval BN + the epilogues of the stem, bn1, bn3 (+ identity or
    projection shortcut) and the stride-2 groups, against the JAX module
    composition (res2net.py:137-141, 148-151, 207-212)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 6, 8).astype(np.float32) * 2
    s = rng.randn(2, 9, 6, 8).astype(np.float32)
    mean, var = bn_stats(rng, 8)
    smean, svar = bn_stats(rng, 8)
    mask = lengths_mask(rng, 2, 11) if masked else None

    want = jax_bn_eval(x, mean, var)
    if shortcut == "raw":
        want = want + jnp.asarray(s)
    elif shortcut == "bn":
        want = want + jax_bn_eval(s, smean, svar)
    if relu:
        want = jax.nn.relu(want)
    want = np.asarray(jops.mask_time(want, None if mask is None else jnp.asarray(mask)))

    got = tops.bn_act(
        to_port(x), torch.from_numpy(mean), torch.from_numpy(var), relu=relu,
        shortcut=None if shortcut == "none" else to_port(s),
        shortcut_mean=torch.from_numpy(smean) if shortcut == "bn" else None,
        shortcut_var=torch.from_numpy(svar) if shortcut == "bn" else None,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


def test_bn_act_validates_arguments():
    x = torch.zeros(1, 4, 3, 2)
    m, v = torch.zeros(4), torch.ones(4)
    with pytest.raises(ValueError, match="come together"):
        tops.bn_act(x, m, v, shortcut_mean=m, shortcut_var=v)
    with pytest.raises(ValueError, match="shortcut"):
        tops.bn_act(x, m, v, shortcut=torch.zeros(1, 4, 3, 3))


def test_batchnorm_module_head_and_training():
    rng = np.random.RandomState(6)
    x = rng.randn(4, 10).astype(np.float32)
    mean, var = bn_stats(rng, 10)
    bn = tops.BatchNorm(10)
    bn.running_mean.copy_(torch.from_numpy(mean))
    bn.running_var.copy_(torch.from_numpy(var))
    np.testing.assert_allclose(bn(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_bn_eval(x, mean, var)), **TOL)
    with pytest.raises(NotImplementedError):
        bn(torch.from_numpy(x), training=True)


@pytest.mark.parametrize("strides", [1, 2])
def test_avg_pool_3x3_matches_jax(strides):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 19, 11, 4).astype(np.float32)
    xp = np.asarray(jops.fixed_padding(jnp.asarray(x), 3))
    want = np.asarray(jops.avg_pool_3x3(jnp.asarray(xp), strides))
    got = tops.avg_pool_3x3(tops.fixed_padding(to_port(x), 3), strides)
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


@pytest.mark.parametrize("strides", [1, 2])
def test_masks_match_jax(strides):
    rng = np.random.RandomState(8)
    mask = lengths_mask(rng, 3, 17)
    t_out = (17 - 1) // strides + 1
    want_mask = np.asarray(jops.downsample_mask(jnp.asarray(mask), strides, t_out))
    got_mask = tops.downsample_mask(torch.from_numpy(mask), strides, t_out)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert tops.downsample_mask(None, strides, t_out) is None
    x = rng.randn(3, t_out, 5, 4).astype(np.float32)
    want = np.asarray(jops.mask_time(jnp.asarray(x), jnp.asarray(want_mask)))
    np.testing.assert_array_equal(to_nhwc(tops.mask_time(to_port(x), got_mask)), want)


@pytest.mark.parametrize("kernel,strides", [(3, 1), (3, 2), (1, 1), (1, 2)])
def test_conv_fixed_padding_matches_jax(kernel, strides):
    """SAME at stride 1; explicit padding then VALID at stride 2, so output
    j is anchored at input 2j on both axes (odd T and F check it)."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 17, 9, 6).astype(np.float32)
    mod = jops.ConvFixedPadding(features=8, kernel_size=kernel, strides=strides)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    conv = tops.ConvFixedPadding(6, 8, kernel, strides)
    k = np.asarray(variables["params"]["conv2d"]["conv"]["kernel"])
    conv.conv2d.weight.data = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = conv(to_port(x))
    assert got.shape == (2, 8, want.shape[1], want.shape[2])
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


def test_embedding_head_matches_jax():
    """Stats pool -> NHWC flatten (W, 2C) -> BN -> dense -> BN: the dense rows
    convert by a plain transpose because the port flattens in JAX's order."""
    rng = np.random.RandomState(10)
    x = rng.randn(3, 12, 5, 4).astype(np.float32)
    mask = lengths_mask(rng, 3, 12)
    head = jops.EmbeddingHead(output_dim=7)
    variables = head.init(jax.random.PRNGKey(1), jnp.asarray(x), False, jnp.asarray(mask))
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) * rng.uniform(0.5, 2.0, v.shape).astype(np.float32) + 0.1,
        jax.device_get(variables["batch_stats"]))
    want = np.asarray(head.apply({"params": variables["params"], "batch_stats": stats},
                                 jnp.asarray(x), False, jnp.asarray(mask)))
    port = tops.EmbeddingHead(channels=4, freq=5, output_dim=7)
    port.embedding.weight.data = torch.from_numpy(
        np.ascontiguousarray(np.asarray(variables["params"]["embedding"]["dense"]["kernel"]).T))
    for name in ("pre_bn", "post_bn"):
        getattr(port, name).running_mean.copy_(torch.from_numpy(stats[name]["bn"]["mean"]))
        getattr(port, name).running_var.copy_(torch.from_numpy(stats[name]["bn"]["var"]))
    got = port(to_port(x), False, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
