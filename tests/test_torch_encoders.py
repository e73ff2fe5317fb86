"""PyTorch port, the remaining encoders: DPN, TDNN (every block order),
ECAPA-TDNN and the attentive-stats Res2Net, against the JAX package on the
CPU in float32, with weights converted by ``convert.from_flax`` from
randomized flax variables (BN statistics perturbed away from identity).
Thin registered variants keep every structural feature: DPN's 10-channel
stem (K3/K5 on folded rows on the card, emulated here against JAX's
_GroupedBN and eval BatchNorm), projected and downsampled
blocks with SAME stride-2 padding and cardinality; ECAPA's masked split
stage, SE and attentive pooling at W = 1.

Tolerances: modules rtol = atol = 1e-4; the whole embed on a masked, padded
batch 5e-4 abs (tests/test_torch_res2net.py's); masked-padded == exact-length
in the port 1e-5; training-mode outputs and BN statistics 1e-4; the train
steps at tests/test_torch_trainer.py's tolerances. Also: SpecAugment given
JAX's own draws (exact), the full-size converters and parameter counts, and
``cli.train --specaug``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxsrc2020_speaker_verification_tpu.models as jax_models
from voxsrc2020_speaker_verification_tpu.ops import nn as jops
from voxsrc2020_speaker_verification_tpu.ops import specaug as jspec
from voxsrc2020_speaker_verification_tpu.training import (
    TrainConfig as JaxConfig, create_train_state as jax_create, make_train_step as jax_step)
from voxsrc2020_speaker_verification_tpu_torch import models
from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax, train_state_from_flax
from voxsrc2020_speaker_verification_tpu_torch.models import dpn, ecapa, tdnn
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as tops
from voxsrc2020_speaker_verification_tpu_torch.ops import specaug
from voxsrc2020_speaker_verification_tpu_torch.recipes import RECIPES, get_recipe
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import make_train_step

# the modules (the package's __init__ binds these names to functions)
jax_dpn = importlib.import_module("voxsrc2020_speaker_verification_tpu.models.dpn")
jax_ecapa = importlib.import_module("voxsrc2020_speaker_verification_tpu.models.ecapa")

# one torch thread: the suite runs in parallel workers beside JAX tests
# whose 8-device CPU collectives abort when starved of cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)

# thin variants, registered on both sides under one name
THIN_DPN = dict(output_dim=8, bw=8, k_r=8, cardinality=4, k_sec=(2, 1, 2, 1),
                inc_sec=(4, 4, 4, 8))
jax_dpn.DPN_CONFIGS["dpn_thin_port"] = jax_dpn.DpnConfig(name="dpn_thin_port", **THIN_DPN)
dpn.DPN_CONFIGS["dpn_thin_port"] = dpn.DpnConfig(name="dpn_thin_port", **THIN_DPN)
THIN_ECAPA = dict(channels=16, split=4, mfa_dim=24, att_dim=8, output_dim=8)
jax_ecapa.ECAPA_CONFIGS["ecapa_thin_port"] = jax_ecapa.EcapaConfig(name="ecapa_thin_port",
                                                                   **THIN_ECAPA)
ecapa.ECAPA_CONFIGS["ecapa_thin_port"] = ecapa.EcapaConfig(name="ecapa_thin_port", **THIN_ECAPA)
THIN_ATT = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2), width=(4, 8),
                split=4, output_dim=8, pool="att_stats")
jax_models.register_res2net_variant("res2net_att_thin_port", **THIN_ATT)
models.register_res2net_variant("res2net_att_thin_port", **THIN_ATT)
THIN_TDNN = dict(block_filters=(16, 16, 16, 16, 32), output_dim=8)
TDNN_THIN = jax_models.register_tdnn_variant("tdnn_thin_port", **THIN_TDNN)
models.register_tdnn_variant(TDNN_THIN, **THIN_TDNN)
# (model, feat_dim): the families' thin variants
FAMILIES = {"dpn": ("dpn_thin_port", 16), "tdnn": (TDNN_THIN, 12),
            "ecapa": ("ecapa_thin_port", 12), "res2net_att": ("res2net_att_thin_port", 16)}


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


def lengths_mask(t, lens):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def jax_variables(mod, args, seed):
    variables = mod.init(jax.random.PRNGKey(seed), *args)
    out = {"params": jax.device_get(variables.get("params", {}))}
    if "batch_stats" in variables:
        out["batch_stats"] = perturb(variables["batch_stats"], seed)
    return out


def assert_stats_equal(got_module, want_stats, tol=TOL):
    flat = from_flax({"batch_stats": want_stats})
    state = got_module.state_dict()
    assert flat, "no BN statistics"
    for k, v in flat.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _dpn_block_case(ptype, rng):
    """(JAX module, port module, NHWC inputs): a projected block on the
    10-channel stem output, a downsampled and a normal block on a tuple."""
    if ptype == "projected":
        x = rng.randn(3, 13, 9, 10).astype(np.float32)
        cin = 10
    else:
        x = (rng.randn(3, 13, 9, 8).astype(np.float32), rng.randn(3, 13, 9, 12).astype(np.float32))
        cin = 20
    kw = dict(num_1_a=8, num_3_b=8, num_1_c=8, inc=4, projection_type=ptype, cardinality=4)
    return jax_dpn.DualPathBlock(**kw), dpn.DualPathBlock(cin, **kw), x


MODULES = ["dpn_projected", "dpn_downsampled", "dpn_normal", "ecapa_conv1d", "ecapa_split",
           "ecapa_se_res2", "se_masked", "dense_bn_head"]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", MODULES)
def test_module_matches_jax(case, training):
    """Each module on a masked batch (T = 13, lengths 13, 6, 1), eval mode
    and training mode (outputs and the BN statistics after the forward)."""
    rng = np.random.RandomState(MODULES.index(case))
    mask = lengths_mask(13, [13, 6, 1])
    jm = jnp.asarray(mask)
    if case.startswith("dpn_"):
        jmod, pmod, x = _dpn_block_case(case[4:], rng)
        jargs = (tuple(map(jnp.asarray, x)) if isinstance(x, tuple) else jnp.asarray(x), training, jm)
        pin = tuple(map(to_port, x)) if isinstance(x, tuple) else to_port(x)
        pargs = (pin, training, torch.from_numpy(mask))
    elif case == "se_masked":
        x = rng.randn(3, 13, 1, 16).astype(np.float32) * mask[:, :, None, None]
        jmod, pmod = jops.SqueezeExcitation(ratio=8), tops.SqueezeExcitation(16, 8)
        jargs, pargs = (jnp.asarray(x), jm), (to_port(x), torch.from_numpy(mask))
    elif case == "dense_bn_head":
        # the ECAPA head: BN over (B, 2C) in training/eval, then dense
        x = rng.randn(8, 6).astype(np.float32)
        jmod, pmod = jops.BatchNorm(use_running_average=not training), tops.BatchNorm(6)
        jargs, pargs = (jnp.asarray(x),), (torch.from_numpy(x), training)
    else:
        x = rng.randn(3, 13, 1, 16).astype(np.float32) * mask[:, :, None, None]
        jmod, pmod, extra = {
            "ecapa_conv1d": (jax_ecapa.Conv1dReluBn(16, 5, dilation=2),
                             ecapa.Conv1dReluBn(16, 16, 5, 2), False),
            "ecapa_split": (jax_ecapa.EcapaSplitConv(split=4, width=4, dilation=3),
                            ecapa.EcapaSplitConv(4, 4, dilation=3), True),
            "ecapa_se_res2": (jax_ecapa.SERes2Block(channels=16, split=4, dilation=2),
                              ecapa.SERes2Block(16, 4, 2), True)}[case]
        jargs = (jnp.asarray(x), training) + ((jm,) if extra else ())
        pargs = (to_port(x), training) + ((torch.from_numpy(mask),) if extra else ())
    # flax initializes in eval mode (a training-mode init would move the
    # statistics before they are perturbed)
    init_args = jargs
    if training and case != "dense_bn_head" and case != "se_masked":
        init_args = (jargs[0], False) + jargs[2:]
    variables = jax_variables(jmod, init_args, MODULES.index(case))
    mutable = ["batch_stats"] if training and "batch_stats" in variables else False
    want = jmod.apply(variables, *jargs, mutable=mutable)
    if mutable:
        want, new_stats = want
    pmod.load_state_dict(from_flax(variables))
    got = pmod(*pargs)
    outs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in outs:
        g = to_nhwc(g) if g.ndim == 4 else g.detach().numpy()
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    if mutable:
        assert_stats_equal(pmod, new_stats["batch_stats"])


@pytest.mark.parametrize("t,kernel,strides,dilation,card", [
    (17, 3, 2, 1, 1), (16, 3, 2, 1, 1), (16, 1, 2, 1, 1), (15, (3, 1), 1, (3, 1), 1),
    (14, 3, 2, 1, 4), (12, 2, 1, 1, 1)])
def test_conv2d_same_matches_jax(t, kernel, strides, dilation, card):
    """SAME padding as XLA pads it (lo = total // 2: (0, 1) at stride 2 and
    even T), at any stride, with time dilation and with groups."""
    x = np.random.RandomState(t).randn(2, t, 7, 8).astype(np.float32)
    jmod = jops.Conv2d(8, kernel, strides=strides, padding="SAME", dilation=dilation,
                       cardinality=card)
    variables = jax_variables(jmod, (jnp.asarray(x),), t)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    pmod = tops.Conv2d(8, 8, kernel, strides, "SAME", dilation, card)
    pmod.load_state_dict(from_flax(variables))
    got = to_nhwc(pmod(to_port(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape,groups", [((16, 24, 16, 10), 8), ((16, 24, 16, 10), 1),
                                          ((8, 13, 8, 10), 2)], ids=str)
def test_folded_bn_matches_jax(shape, groups):
    """dpn68's 10-channel BN on the cluster design's folded rows (K5,
    training, with the running update) and K3's folded path (eval, relu and
    the time mask), emulated on the CPU (tests/test_torch_plans.py) at thin
    stem shapes from a numpy seed, against the JAX package's _GroupedBN
    (through BatchNorm under bn_groups) and eval BatchNorm with relu and
    mask_time, float32, within 1e-4."""
    from test_torch_plans import bn_act_folded, bn_train_folded

    rng = np.random.RandomState(sum(shape) + groups)
    x = (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    mask = lengths_mask(shape[1], rng.randint(1, shape[1] + 1, shape[0]))
    jmod = jops.BatchNorm()
    variables = jax_variables(jmod, (jnp.asarray(x),), groups)
    with jops.bn_groups(groups):
        want, new_stats = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    xp = to_port(x).contiguous(memory_format=torch.channels_last)
    stats = variables["batch_stats"]["bn"]
    rm, rv = (torch.from_numpy(np.array(stats[k], np.float32)) for k in ("mean", "var"))
    plan = tops.bn_train_plan(tuple(xp.shape), groups, torch.float32, 0, False)
    assert plan["design"] == "cluster" and plan["fold"] % 2 == 0
    got = bn_train_folded(xp, rm, rv, groups, plan, relu=False)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)
    for k, v in (("mean", rm), ("var", rv)):
        np.testing.assert_allclose(v.numpy(), np.asarray(new_stats["batch_stats"]["bn"][k]), **TOL)

    eval_y = jmod.apply(variables, jnp.asarray(x), use_running_average=True)
    want = np.maximum(np.asarray(eval_y), 0) * mask[:, :, None, None]
    k3 = tops.bn_act_plan(tuple(xp.shape), torch.float32)
    assert k3 == {"design": "fold", "fold": 2}
    mean, var = (torch.from_numpy(np.array(stats[k], np.float32)) for k in ("mean", "var"))
    got = bn_act_folded(xp, mean, var, torch.from_numpy(mask), k3["fold"])
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


# ---------------------------------------------------------------------------
# whole encoders
# ---------------------------------------------------------------------------

def padded_batch(feat_dim, t=32, lens=(32, 24, 9, 1), seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), t, feat_dim).astype(np.float32)
    mask = lengths_mask(t, lens)
    return x * mask[..., None], mask


@functools.lru_cache(maxsize=None)
def jax_init(name, feat_dim):
    """(JAX model, its initial variables), jitted and shared by the tests."""
    jmodel = jax_models.get_model(name)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 32, feat_dim)), False))(
        jax.random.PRNGKey(0))
    return jmodel, jax.device_get(variables)


def encoder_pair(name, feat_dim, seed=0):
    """(JAX model, variables with BN statistics perturbed by ``seed``, port
    encoder with them loaded)."""
    jmodel, variables = jax_init(name, feat_dim)
    variables = {"params": variables["params"],
                 "batch_stats": perturb(variables["batch_stats"], seed)}
    port = models.get_model(name, feat_dim=feat_dim)
    port.load_state_dict(from_flax(variables))
    return jmodel, variables, port


@pytest.mark.parametrize("family", list(FAMILIES))
def test_embed_matches_jax(family):
    """The eval embed of a masked, padded batch (lengths 32, 24, 9, 1)
    against JAX at 5e-4, and in the port the padded rows against their
    exact-length forward at 1e-5. DPN's strided SAME convs anchor output j
    at input 2j - 1 or 2j by the parity of T (in both packages), so its
    exact lengths share the padded length's residue mod 8 (24 of 32)."""
    name, feat_dim = FAMILIES[family]
    jmodel, variables, port = encoder_pair(name, feat_dim)
    x, mask = padded_batch(feat_dim)
    want = np.asarray(jax.jit(lambda v, x, m: jmodel.apply(v, x, False, m))(
        variables, jnp.asarray(x), jnp.asarray(mask)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), False, torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
        rows = [1] if family == "dpn" else [1, 2, 3]
        for i in rows:
            n = int(mask[i].sum())
            exact = port(torch.from_numpy(x[i:i + 1, :n]), False)
            np.testing.assert_allclose(got[i:i + 1].numpy(), exact.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_training_forward_matches_jax(family):
    """One training-mode forward with two BN groups of four rows (with two
    rows a group, the 2-D head BNs normalize a pair to about +-1, rounding
    noise on both sides): the output and every running statistic after it."""
    name, feat_dim = FAMILIES[family]
    jmodel, variables, port = encoder_pair(name, feat_dim, seed=1)
    x = np.random.RandomState(6).randn(8, 24, feat_dim).astype(np.float32)
    with jops.bn_groups(2):  # read while the jitted apply traces
        want, new = jax.jit(lambda v, x: jmodel.apply(v, x, True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    port.set_bn_groups(2)
    got = port(torch.from_numpy(x), True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert_stats_equal(port, new["batch_stats"])


@pytest.mark.parametrize("order", tdnn.BLOCK_ORDERS)
def test_tdnn_block_orders_match_jax(order):
    """Every TdnnBlock order (a (3, 1) conv at time dilation 2, then its
    parts), eval mode and training mode with the BN statistics after it."""
    jax_tdnn = importlib.import_module("voxsrc2020_speaker_verification_tpu.models.tdnn")
    x = np.random.RandomState(7).randn(4, 15, 1, 16).astype(np.float32)
    jmod = jax_tdnn.TdnnBlock(filters=32, kernel_size=(3, 1), dilation=(2, 1), order=order)
    variables = jax_variables(jmod, (jnp.asarray(x), False), 7)
    pmod = tdnn.TdnnBlock(16, 32, (3, 1), (2, 1), order=order)
    pmod.load_state_dict(from_flax(variables))
    for training in (False, True):
        want = jmod.apply(variables, jnp.asarray(x), training,
                          mutable=["batch_stats"] if training else False)
        got = to_nhwc(pmod(to_port(x), training))
        np.testing.assert_allclose(got, np.asarray(want[0] if training else want), **TOL)
        if training and "bn" in order:
            assert_stats_equal(pmod, want[1]["batch_stats"])


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

STEP_CFG = dict(projection="sc_cm_linear", num_classes=16, dataset_length=160,
                feat_length=24, batch_size=16, num_accumulation_steps=2, bn_groups=2,
                bf16=False)


def assert_rel(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-4)
    assert err <= tol, f"{msg}: relative error {err} > {tol}"


@pytest.mark.parametrize("family", ["res2net_att", "dpn"])
def test_train_step_matches_jax(family):
    """One optimizer step (A = 2 microbatches of 16, two BN groups, the
    sc_cm_linear head) from the same state at step 40 (constant LR, growing
    margin) against ``make_train_step``: metrics and statistics 1e-4, the
    gradient norm 2e-3, parameters 1e-3 and the momentum trace 5e-2 (the
    tolerances of tests/test_torch_trainer.py, which says why)."""
    name, feat_dim = FAMILIES[family]
    cfg = dict(STEP_CFG, model=name, feat_dim=feat_dim)
    jstate = jax_create(JaxConfig(**cfg), jax.random.PRNGKey(0)).replace(step=jnp.int32(40))
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 16, 24, feat_dim).astype(np.float32)
    labels = rng.randint(0, 16, (2, 16)).astype(np.int32)
    start = jax.device_get(jstate)
    jnew, jm = jax.jit(jax_step(JaxConfig(**cfg)))(jstate, jnp.asarray(feats),
                                                   jnp.asarray(labels), jax.random.PRNGKey(1))
    jnew = jax.device_get(jnew)
    state = train_state_from_flax(int(start.step), start.params, start.batch_stats,
                                  start.momentum, config=TrainConfig(**cfg), device="cpu")
    state, m = make_train_step(TrainConfig(**cfg))(state, torch.from_numpy(feats),
                                                   torch.from_numpy(labels).long())
    for k, v in jm.items():
        assert_rel(float(m[k]), float(v), 2e-3 if k == "gradient_norm" else 1e-4, k)
    for group, tree, got, tol in (("params", jnew.params, state.params, 1e-3),
                                  ("batch_stats", jnew.batch_stats, state.batch_stats, 1e-4),
                                  ("momentum", jnew.momentum, state.momentum, 5e-2)):
        flat = from_flax({"params": tree} if group != "batch_stats" else {"batch_stats": tree},
                         projection=True)
        assert set(flat) == set(got), group
        for k, v in flat.items():
            assert_rel(got[k].detach().numpy(), v.numpy(), tol, f"{group} {k}")


def test_dpn_remat_step_equals_plain():
    """``--remat-stages`` reaches DPN: a step with stages 0-1 of dual-path
    blocks rematerialized equals the plain step bit for bit on the CPU (the
    recompute leaves the BN statistics alone), and checkpoints run."""
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import create_train_state

    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(1, 8, 24, 16).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 16, (1, 8)))
    runs = []
    for remat in (False, True):
        cfg = TrainConfig(**dict(STEP_CFG, model="dpn_thin_port", feat_dim=16, batch_size=8,
                                 num_accumulation_steps=1, remat=remat,
                                 remat_stages=(0, 1) if remat else None))
        state = create_train_state(cfg, "cpu", seed=2)
        assert sum(r for _, _, r in state.net.encoder.blocks) == (3 if remat else 0)
        state.step = 40
        state, m = make_train_step(cfg)(state, feats, labels)
        runs.append((state, float(m["loss"])))
    (plain, lp), (remat, lr_) = runs
    assert lp == lr_
    for k, v in plain.net.state_dict().items():
        assert torch.equal(remat.net.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------

def jax_draws(key, b, t, f):
    """JAX's own (start, width) draws of ops/specaug.py, step by step."""
    def one(k, dim, param):
        kf, ks, kw = jax.random.split(k, 3)
        fw = jax.random.randint(kf, (), 0, param)
        start = jax.random.randint(ks, (), 0, jnp.maximum(dim - fw, 1))
        width = jnp.where(fw > 0, jax.random.randint(kw, (), 0, jnp.maximum(fw, 1)), 0)
        return int(start), int(width)
    out = []
    for k in jax.random.split(key, b):
        kt, kf = jax.random.split(k)
        out.append(one(kt, t, jspec.TIME_PARAM) + one(kf, f, jspec.FREQ_PARAM))
    ts, tw, fs, fw = (torch.tensor(c) for c in zip(*out))
    return specaug.Draws(ts, tw, fs, fw)


def test_spec_augment_with_jax_draws_matches_jax():
    x = np.random.RandomState(0).randn(16, 50, 20).astype(np.float32) + 1.0
    key = jax.random.PRNGKey(3)
    want = np.asarray(jspec.spec_augment(key, jnp.asarray(x)))
    got = specaug.spec_augment(torch.from_numpy(x), jax_draws(key, 16, 50, 20))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()


def test_spec_augment_draws_follow_the_three_step_rule():
    """Widths at most param - 2 (7 frames, 4 bins), every width from 0 up
    to that drawn, masks inside the utterance, seeded draws repeat."""
    d = specaug.draw(20000, 11, 6, torch.Generator().manual_seed(0))
    for start, width, dim, param in ((d.time_start, d.time_width, 11, specaug.TIME_PARAM),
                                     (d.freq_start, d.freq_width, 6, specaug.FREQ_PARAM)):
        assert set(width.tolist()) == set(range(param - 1))
        assert int(start.min()) >= 0 and int((start + width).max()) <= dim
        assert int(start.max()) <= dim - 1
    again = specaug.draw(20000, 11, 6, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    y = specaug.spec_augment(torch.ones(200, 11, 6), specaug.Draws(*(v[:200] for v in d)))
    t, f = np.arange(11)[:, None], np.arange(6)[None, :]
    for i in range(200):
        ts, tw, fs, fw = (int(v[i]) for v in d)
        hit = ((t >= ts) & (t < ts + tw)) | ((f >= fs) & (f < fs + fw))
        np.testing.assert_array_equal(y[i].numpy(), np.where(hit, 0.0, 1.0))


def test_train_cli_specaug_on_cpu(tmp_path):
    """``cli.train --specaug`` runs the ECAPA recipe's config with
    SpecAugment on the CPU; without the flag the CLI turns it off, as the
    JAX package's CLI does."""
    args = ["--recipe", "ecapa_vox2_dev_aug", "--model", "ecapa_thin_port", "--synthetic",
            "--device", "cpu", "--batch-size", "4", "--num-accumulation-steps", "1",
            "--feat-length", "16", "--num-classes", "8", "--max-steps", "1", "--log-every", "1",
            "--no-checkpoint", "--exp-root", str(tmp_path)]
    run = train_cli.main(args + ["--specaug"])
    assert run.result.state.step == 1 and np.isfinite(run.result.history[-1]["loss"])
    config, _ = get_recipe("ecapa_vox2_dev_aug")
    assert config.specaug
    parsed = train_cli.build_parser().parse_args(args)
    assert parsed.specaug is False


# ---------------------------------------------------------------------------
# every model and recipe, full size
# ---------------------------------------------------------------------------

FULL = ["tdnn", "dpn68", "ecapa_tdnn_512", "ecapa_tdnn_1024", "res2net101_w24_s4_c32_att",
        "res2net152_w24_s4_c32_att", "res2net200_w24_s4_c32_att"]


@pytest.mark.parametrize("name", FULL)
def test_from_flax_loads_full_size_models(name):
    """JAX's full-size variables (shapes by ``jax.eval_shape``, filled with
    random arrays) convert and load into the port's model with strict=True."""
    feat_dim = 40 if name in ("tdnn", "dpn68") else 80
    jmodel = jax_models.get_model(name)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, feat_dim)), False))
    rng = np.random.RandomState(0)
    variables = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    with torch.device("meta"):
        port = models.get_model(name, feat_dim=feat_dim)
    port.load_state_dict(from_flax(variables), strict=True, assign=True)
    params = shapes["params"]
    head = params["head"] if "head" in params else params
    assert port.config.output_dim == head["embedding"]["dense"]["kernel"].shape[-1]


# tests/test_models.py's reference rows: params + BN moving statistics, in
# millions
@pytest.mark.parametrize("name,feat_dim,expected_m", [
    ("tdnn", 40, 3.5), ("dpn68", 40, 13.9), ("res2net101_w24_s4_c32_att", 80, 29.3),
    ("res2net152_w24_s4_c32_att", 80, 38.31), ("res2net200_w24_s4_c32_att", 80, 40.90)])
def test_param_counts_match_reference(name, feat_dim, expected_m):
    with torch.device("meta"):
        model = models.get_model(name, feat_dim=feat_dim)
    n = sum(t.numel() for t in model.state_dict().values())
    assert abs(n / 1e6 - expected_m) < 0.11, (name, n)


def test_every_model_and_recipe_builds():
    """get_model builds every name of the JAX package's MODEL_NAMES, and
    every recipe's default model builds a training net (shapes only)."""
    from voxsrc2020_speaker_verification_tpu_torch.training.speaker_net import SpeakerNet

    assert set(models.MODEL_NAMES) == set(jax_models.MODEL_NAMES)
    with torch.device("meta"):
        for name in models.MODEL_NAMES:
            assert models.get_model(name, feat_dim=40).config.output_dim > 0
        for recipe in RECIPES:
            cfg, _ = get_recipe(recipe)
            net = SpeakerNet(cfg.model, cfg.projection, cfg.num_classes, cfg.num_centers,
                             cfg.feat_dim, torch.bfloat16, cfg.bn_groups, remat=cfg.remat)
            assert net.projection is not None
    with pytest.raises(ValueError, match="unknown model"):
        models.get_model("res2net_missing")
