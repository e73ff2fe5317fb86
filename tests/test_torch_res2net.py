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

from voxsrc2020_speaker_verification_tpu.ops import nn as jops
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


@pytest.mark.parametrize("split,width", [(4, 6), (6, 4)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_split_conv_stride1_training_matches_jax(split, width, masked, groups):
    """The stride-1 chain in training (``split_chain_train``'s plain
    version, K9 / K9b's yardstick) against the JAX module under
    bn_groups(g): output, updated running mean/var, and the gradients of x
    and of the kernel (jax.vjp against torch autograd), float32."""
    rng = np.random.RandomState(10 * split + 2 * groups + int(masked))
    b, t, f = 4, 11, 6
    mask = lengths_mask(b, t, [11, 7, 11, 3]) if masked else None
    x = (rng.randn(b, t, f, split * width) * 1.5 + 0.2).astype(np.float32)
    cot = rng.randn(b, t, f, split * width).astype(np.float32)
    mod = JaxSplit(split=split, width=width, strides=1)
    variables = mod.init(jax.random.PRNGKey(groups), jnp.asarray(x), False)
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": perturb(variables["batch_stats"], groups)}
    jmask = None if mask is None else jnp.asarray(mask)

    def f_jax(xj, params):
        with jops.bn_groups(groups):
            return mod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xj,
                             True, jmask, mutable=["batch_stats"])

    want, vjp, mut = jax.vjp(f_jax, jnp.asarray(x), variables["params"], has_aux=True)
    want_dx, want_dp = vjp(jnp.asarray(cot))

    port = Res2NetSplitConv(split, width, 1)
    port.load_state_dict(from_flax(variables))
    for bn in port._bns():
        bn.groups = groups
    xt = to_port(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    got = port(xt, True, None if mask is None else torch.from_numpy(mask))
    got.backward(to_port(cot))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(port.weight.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(want_dp["kernel"]), **TOL)
    for i, bn in enumerate(port._bns()):
        st = mut["batch_stats"][f"bn{i}"]["bn"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st["mean"]), **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st["var"]), **TOL)


# the stride-2 stage: (split, width, T, F, lengths (None: no zeroed rows),
# dtype); odd and even T and F, s = 4 and 6, w = 5 (K10's single-channel
# design on the card) and 8, inputs whose rows past a length are zero (bn1's
# masked epilogue); the bf16 case within 2e-2 of JAX relative to the
# largest magnitude (XLA may fuse the nine bf16 adds of the pool and round
# once: the pool's bit-equality is held on the card, against the port's
# own plain version)
STRIDE2_CASES = [
    (4, 5, 17, 9, None, "float32"), (4, 8, 16, 10, (16, 7), "float32"),
    (6, 5, 16, 9, (16, 3), "float32"), (6, 8, 17, 10, None, "float32"),
    (4, 5, 16, 10, (9, 16), "float32"), (6, 8, 16, 9, (1, 16), "float32"),
    (4, 8, 17, 11, (17, 0), "float32"), (6, 5, 15, 12, None, "float32"),
    (4, 8, 16, 10, (16, 7), "bfloat16"),
]


@pytest.mark.parametrize("split,width,t,f,lengths,dtype", STRIDE2_CASES, ids=str)
def test_split_conv_stride2_matches_jax(split, width, t, f, lengths, dtype):
    """The stride-2 stage in eval (``split_stride2_reference``, K10's plain
    version, and ``Res2NetSplitConv(strides=2)``) against the JAX module:
    1e-4 in float32."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import split_stride2_reference

    rng = np.random.RandomState(2 + 10 * split + width + t + f)
    x = rng.randn(2, t, f, split * width).astype(np.float32)
    if lengths is not None:
        x *= lengths_mask(2, t, lengths)[:, :, None, None]
    variables, want = jax_module_case(JaxSplit(split=split, width=width, strides=2), x, None,
                                      split + width)
    port = Res2NetSplitConv(split, width, 2)
    port.load_state_dict(from_flax(variables))
    xt = to_port(x)
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        want = np.asarray(JaxSplit(split=split, width=width, strides=2).apply(
            variables, jx, False).astype(jnp.float32))
        xt = xt.bfloat16()
    bns = port._bns()
    plain = split_stride2_reference(xt.contiguous(memory_format=torch.channels_last),
                                    port.weight.to(xt.dtype), [bn.running_mean for bn in bns],
                                    [bn.running_var for bn in bns])
    got = port(xt)
    assert got.shape == plain.shape == (2, split * width, (t - 1) // 2 + 1, (f - 1) // 2 + 1)
    for out in (plain, got):
        if dtype == "bfloat16":
            assert out.dtype == torch.bfloat16
            assert np.abs(to_nhwc(out.float()) - want).max() <= 2e-2 * np.abs(want).max()
        else:
            np.testing.assert_allclose(to_nhwc(out), want, **TOL)


# the stride-2 stage in training: (split, width, T, F, bn_groups); s = 4 and
# 6, w = 5 (K11's FMA design on the card) and 8, odd and even T and F
STRIDE2_TRAIN_CASES = [(4, 5, 11, 9, 1), (4, 8, 12, 10, 2), (6, 5, 12, 9, 2), (6, 8, 11, 10, 1),
                       (4, 8, 13, 12, 2), (6, 5, 10, 11, 1)]


def jax_stride2_train(split, width, x, cot, groups, dtype=jnp.float32):
    """The JAX module's stride-2 stage in training under bn_groups(groups),
    through ops.grouped_conv's custom_vjp: (its variables, output, updated
    batch_stats, dx, dparams)."""
    mod = JaxSplit(split=split, width=width, strides=2)
    variables = mod.init(jax.random.PRNGKey(split + width), jnp.asarray(x), False)
    variables = {"params": jax.device_get(variables["params"]),
                 "batch_stats": perturb(variables["batch_stats"], width)}

    def f_jax(xj, params):
        with jops.bn_groups(groups):
            return mod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             xj.astype(dtype), True, mutable=["batch_stats"])

    want, vjp, mut = jax.vjp(f_jax, jnp.asarray(x), variables["params"], has_aux=True)
    dx, dp = vjp(jnp.asarray(cot, want.dtype)) if dtype == jnp.float32 else (None, None)
    return variables, want, mut, dx, dp


@pytest.mark.parametrize("split,width,t,f,groups", STRIDE2_TRAIN_CASES, ids=str)
def test_split_conv_stride2_training_matches_jax(split, width, t, f, groups):
    """The stride-2 stage in training (``split_stride2_train``'s plain
    version, K11 / K11b's yardstick, through ``Res2NetSplitConv``) against
    the JAX module under bn_groups(g), whose kernel gradient comes from
    ops.grouped_conv's custom_vjp: the output, the updated running mean and
    variance (counted over the output's rows), and the gradients of x and
    of the kernel (jax.vjp against torch autograd), float32 at 1e-4."""
    rng = np.random.RandomState(7 * split + width + t + f + groups)
    b = 4
    x = (rng.randn(b, t, f, split * width) * 1.5 + 0.2).astype(np.float32)
    cot = rng.randn(b, (t - 1) // 2 + 1, (f - 1) // 2 + 1, split * width).astype(np.float32)
    variables, want, mut, want_dx, want_dp = jax_stride2_train(split, width, x, cot, groups)

    port = Res2NetSplitConv(split, width, 2)
    port.load_state_dict(from_flax(variables))
    for bn in port._bns():
        bn.groups = groups
    xt = to_port(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    got = port(xt, True)
    got.backward(to_port(cot))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(port.weight.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(want_dp["kernel"]), **TOL)
    for i, bn in enumerate(port._bns()):
        st = mut["batch_stats"][f"bn{i}"]["bn"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st["mean"]), **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st["var"]), **TOL)


def test_split_conv_stride2_training_bf16_forward_matches_jax():
    """The bf16 forward of the stride-2 stage in training against the JAX
    module in bf16: within 2e-2 of the largest magnitude (rounding at the
    same points, summed in another order)."""
    rng = np.random.RandomState(31)
    x = (rng.randn(4, 12, 10, 4 * 8) * 1.5 + 0.2).astype(np.float32)
    variables, want, _, _, _ = jax_stride2_train(4, 8, x, None, 2, jnp.bfloat16)
    port = Res2NetSplitConv(4, 8, 2)
    port.load_state_dict(from_flax(variables))
    for bn in port._bns():
        bn.groups = 2
    got = port(to_port(x).bfloat16().contiguous(memory_format=torch.channels_last), True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(to_nhwc(got.float()) - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("policy", [None, "nothing_saveable", "dots_saveable"])
def test_thin_res2net_remat_step_equals_plain(policy):
    """A training forward and backward of the thin Res2Net (its stride-2
    block included) with every block rematerialized equals the plain one
    from the same weights: output and gradients within 1e-6, the BN running
    statistics bit-equal (the recompute leaves them alone). On the CPU the
    stride-2 stage takes its plain version ("train_plain"), once more a
    forward in the recompute; on the card K11 runs again under None and
    nothing_saveable and not under dots_saveable
    (tests/test_torch_kernels.py)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    torch.manual_seed(5)
    nets = [get_model(THIN, feat_dim=40), get_model(THIN, feat_dim=40, remat=True,
                                                    remat_policy=policy)]
    for p in nets[0].parameters():
        torch.nn.init.normal_(p, std=0.2)
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.from_numpy(np.random.RandomState(8).randn(4, 24, 40).astype(np.float32))
    runs = []
    for net in nets:
        net.set_bn_groups(2)
        before = rn.split_stride2_route_counts()["train_plain"]
        y = net(x, True)
        y.square().sum().backward()
        runs.append((y.detach(), {k: p.grad.clone() for k, p in net.named_parameters()},
                     {k: v.clone() for k, v in net.state_dict().items() if "running" in k},
                     rn.split_stride2_route_counts()["train_plain"] - before))
    (y0, g0, s0, n0), (y1, g1, s1, n1) = runs
    assert (n0, n1) == (1, 2)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-6, atol=1e-6)
    for k, v in g0.items():
        np.testing.assert_allclose(g1[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    assert all(torch.equal(s1[k], v) for k, v in s0.items())


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
    # rematerialization is ported, with the policies the port can map
    # (models/res2net.py:REMAT_POLICIES); another policy name raises
    assert get_model(THIN, feat_dim=40, remat=True, remat_policy="dots_saveable").blocks[0][2]
    with pytest.raises(ValueError, match="dots_saveable"):
        get_model(THIN, feat_dim=40, remat=True, remat_policy="save_anything_except_these_names")
    # every model of the JAX package is ported; an unknown name raises
    assert get_model("tdnn", feat_dim=40).config.output_dim == 256
    assert get_model("res2net101_w24_s4_c32_att", feat_dim=40).config.pool == "att_stats"
    with pytest.raises(ValueError, match="unknown model"):
        get_model("res2net_not_a_model")
