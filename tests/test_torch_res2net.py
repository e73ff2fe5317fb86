"""PyTorch port, model layer: the Res2Net modules and the whole embed against
the JAX package on the CPU in float32, with weights converted by
``convert.from_flax`` from randomized flax variables (BN statistics
perturbed away from identity, so a normalization bug cannot hide).

Tolerances: modules rtol = atol = 1e-4 (tests/test_models.py:87); the whole
embed on a masked, padded batch 5e-4 abs; bf16 embed 2e-2 abs (rounding at
the same points, summed in another order); masked-padded == exact-length in
the port 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.models import get_model as jax_get_model
from voxsrc2020_speaker_verification_tpu.models import (
    register_res2net_variant as jax_register)
from voxsrc2020_speaker_verification_tpu.models.res2net import (
    BottleneckBlockV1 as JaxBlock, Res2NetSplitConv as JaxSplit)
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax, init_weights
from voxsrc2020_speaker_verification_tpu_torch.models import (
    get_model, register_res2net_variant)
from voxsrc2020_speaker_verification_tpu_torch.models.res2net import (
    BottleneckBlockV1, Res2NetSplitConv)
from voxsrc2020_speaker_verification_tpu_torch.speaker_net import build_speaker_net

# thin Res2Net: 3 blocks (two stride-1 with the masked split chain, one
# stride-2 with projection), widths 4 and 8, split 4
THIN = "res2net50_thin_torch_port"
THIN_KW = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
               width=(4, 8), split=4, output_dim=16)
jax_register(THIN, **THIN_KW)
register_res2net_variant(THIN, **THIN_KW)
TOL = dict(rtol=1e-4, atol=1e-4)


def to_port(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc, np.float32)).permute(0, 3, 1, 2)


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def perturb(stats, seed):
    """Non-trivial BN statistics: mean + N(0, 0.3), var * U(0.5, 2)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) + rng.randn(*v.shape).astype(np.float32) * 0.3
                      if "mean" in str(p[-1])
                      else np.asarray(v) * rng.uniform(0.5, 2.0, v.shape).astype(np.float32)),
        jax.device_get(stats))


def jax_module_case(mod, x, mask, seed):
    variables = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x), False)
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": perturb(variables["batch_stats"], seed)}
    want = mod.apply(variables, jnp.asarray(x), False,
                     None if mask is None else jnp.asarray(mask))
    return variables, np.asarray(want)


def lengths_mask(b, t, lens):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_split_conv_stride1_matches_jax(masked):
    rng = np.random.RandomState(1)
    mask = lengths_mask(3, 15, [15, 9, 2]) if masked else None
    x = rng.randn(3, 15, 7, 4 * 6).astype(np.float32)
    variables, want = jax_module_case(JaxSplit(split=4, width=6, strides=1), x, mask, 1)
    port = Res2NetSplitConv(4, 6, 1)
    port.load_state_dict(from_flax(variables))
    got = port(to_port(x), False, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


def test_split_conv_stride2_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 17, 9, 4 * 5).astype(np.float32)
    variables, want = jax_module_case(JaxSplit(split=4, width=5, strides=2), x, None, 2)
    port = Res2NetSplitConv(4, 5, 2)
    port.load_state_dict(from_flax(variables))
    got = port(to_port(x))
    assert got.shape == (2, 20, 9, 5)
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


@pytest.mark.parametrize("strides,projection", [(1, True), (2, True), (1, False)])
def test_bottleneck_matches_jax(strides, projection):
    rng = np.random.RandomState(3)
    cin = 6 if projection else 16
    x = rng.randn(3, 13, 9, cin).astype(np.float32)
    mask = lengths_mask(3, 13, [13, 6, 1])
    mod = JaxBlock(filters=4, strides=strides, use_projection=projection, split=4, width=3)
    variables, want = jax_module_case(mod, x, mask, 3)
    port = BottleneckBlockV1(cin, 4, strides, projection, 4, 3)
    port.load_state_dict(from_flax(variables))
    got = port(to_port(x), False, torch.from_numpy(mask))
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


@pytest.fixture(scope="module")
def thin_pair():
    """(JAX encoder variables, port SpeakerNet state_dict) of the thin model."""
    model = jax_get_model(THIN)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, 32, 40)), False))(
        jax.random.PRNGKey(0))
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": perturb(variables["batch_stats"], 0)}
    state = from_flax({k: {"encoder": v} for k, v in variables.items()})
    return variables, state


def padded_batch(seed=4):
    rng = np.random.RandomState(seed)
    lens = [120, 77, 31, 1]
    x = rng.randn(4, 120, 40).astype(np.float32)
    mask = lengths_mask(4, 120, lens)
    return x * mask[..., None], mask


@pytest.mark.parametrize("bf16", [False, True])
def test_embed_matches_jax(thin_pair, bf16):
    variables, state = thin_pair
    x, mask = padded_batch()
    # SpeakerNet.embed: the encoder in eval mode, cast to float32
    encoder = jax_get_model(THIN, dtype=jnp.bfloat16 if bf16 else None)
    embed = jax.jit(lambda v, x, m: encoder.apply(v, x, False, m).astype(jnp.float32))
    want = np.asarray(embed(variables, jnp.asarray(x), jnp.asarray(mask)))
    net = build_speaker_net(TrainConfig(model=THIN, feat_dim=40, bf16=bf16), "cpu")
    net.load_state_dict(state)
    with torch.inference_mode():
        got = net.embed(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (4, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 if bf16 else 5e-4)


def test_masked_padded_equals_exact_length():
    """In the port: a zero-padded utterance with its mask embeds as the
    exact-length utterance (seeded init, non-identity BN statistics)."""
    cfg = TrainConfig(model=THIN, feat_dim=40, bf16=False)
    net = build_speaker_net(cfg, "cpu")
    net.load_state_dict(init_weights(cfg, torch.Generator().manual_seed(5)))
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 100, 40).astype(np.float32))
    padded = torch.zeros(1, 128, 40)
    padded[:, :100] = x
    mask = (torch.arange(128) < 100).float()[None]
    with torch.inference_mode():
        exact = net.embed(x)
        masked = net.embed(padded, mask)
    np.testing.assert_allclose(masked.numpy(), exact.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,expected_m", [
    ("res2net50_w24_s4_c64", 32.2),
    ("res2net50_w24_s4_c32", 17.7),
    ("res2net50_w8_s6_c16", 4.8),
])
def test_param_counts_match_reference(name, expected_m):
    """Params + BN moving statistics, from shapes (meta tensors, no forward),
    against tests/test_models.py's reference rows."""
    with torch.device("meta"):
        model = get_model(name, feat_dim=80)
    n = sum(t.numel() for t in model.state_dict().values())
    assert abs(n / 1e6 - expected_m) < 0.11, (name, n)


def test_from_flax_covers_every_entry(thin_pair):
    _, state = thin_pair
    net = build_speaker_net(TrainConfig(model=THIN, feat_dim=40, bf16=False), "cpu")
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert "encoder.layer1_block1.split_conv.weight" in state
    assert "encoder.layer2_block1.proj_bn.running_var" in state


def test_init_weights_is_seeded_and_non_trivial():
    cfg = TrainConfig(model=THIN, feat_dim=40)
    a = init_weights(cfg, torch.Generator().manual_seed(7))
    b = init_weights(cfg, torch.Generator().manual_seed(7))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    var = torch.cat([v for k, v in a.items() if k.endswith("running_var")])
    mean = torch.cat([v for k, v in a.items() if k.endswith("running_mean")])
    assert var.min() >= 0.5 and var.max() <= 2.0 and mean.abs().max() > 0
    w = a["encoder.initial_conv.conv2d.weight"]
    assert w.abs().max() <= 2 * (1 / 9) ** 0.5 / 0.87962566103423978 + 1e-6


def test_unported_paths_raise():
    net = get_model(THIN, feat_dim=40)
    with pytest.raises(NotImplementedError):
        net(torch.zeros(1, 30, 40), True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("tdnn")
    with pytest.raises(NotImplementedError, match="att_stats"):
        get_model("res2net101_w24_s4_c32_att")
