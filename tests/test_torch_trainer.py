"""PyTorch port, the training step as a whole: three optimizer steps of the
thin Res2Net with the sc_cm_linear head against one jitted
``make_train_step`` of the JAX package, from the same converted state, on
the CPU in float32; the train CLI on the CPU; checkpoints and the LMFT
resume; the converter from a JAX TrainState.

The steps compared start at global step 40 of a 10-step epoch, where the LR
is constant and the margin has started to grow (at step 0 both are 0, and a
step proves nothing about the update or the margin). Shape: A=2 microbatches
of B=8, two BN groups (four rows per group; with two, the head BN's gradient
is rounding noise on both sides).

Tolerances, relative to each tensor's largest magnitude (or 1e-8 absolute
where a tensor is rounding noise, as the head post-BN's running mean is):
metrics and running statistics 1e-4 after each step; the gradient norm
2e-3, the momentum trace 5e-2 and the parameters (which move by lr times the
trace) 1e-3. These three are the JAX side's own error: its float32 gradients on the CPU stray up to 3e-2 from a
float64 run in the first stage, where the port's stay within 1e-5
(test_train_step_gradient_matches_float64 holds the port to 1e-4 of its
float64 run).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.models import register_res2net_variant as jax_register
from voxsrc2020_speaker_verification_tpu.training import (
    TrainConfig as JaxConfig, create_train_state as jax_create, make_train_step as jax_step)
from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax, train_state_from_flax
from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
from voxsrc2020_speaker_verification_tpu_torch.speaker_net import build_speaker_net
from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import (
    CheckpointManager, restore_or_init)
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
    create_train_state, make_train_step, schedule_values)

# one torch thread: the suite runs in parallel workers beside JAX tests
# whose 8-device CPU collectives abort when starved of cores
torch.set_num_threads(1)

THIN = "res2net50_thin_torch_trainer"
THIN_KW = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
               width=(4, 8), split=4, output_dim=16)
jax_register(THIN, **THIN_KW)
register_res2net_variant(THIN, **THIN_KW)

CFG = dict(model=THIN, projection="sc_cm_linear", num_classes=16, dataset_length=160,
           feat_dim=16, feat_length=24, batch_size=16, num_accumulation_steps=2,
           bn_groups=2, bf16=False)
START = 40
TOL = 1e-4


def assert_rel(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-4)
    assert err <= tol, f"{msg}: relative error {err} > {tol}"


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        labels = rng.randint(0, CFG["num_classes"], (2, 16)).astype(np.int32)
        # zero-mean features: a channel mean far above its spread makes the
        # E[x^2] - mean^2 variance a cancellation, and XLA's float32 sums on
        # the CPU then stray ~1e-2 from a float64 run (the port's ~2e-4)
        yield rng.randn(2, 16, CFG["feat_length"], CFG["feat_dim"]).astype(np.float32), labels


@pytest.fixture(scope="module")
def jax_run():
    """The JAX state at step START and after each of three steps."""
    cfg = JaxConfig(**CFG)
    state = jax_create(cfg, jax.random.PRNGKey(0))
    state = state.replace(step=jnp.int32(START))
    step = jax.jit(make_step := jax_step(cfg))
    del make_step
    states, metrics = [jax.device_get(state)], []
    for feats, labels in batches(3):
        state, m = step(state, jnp.asarray(feats), jnp.asarray(labels), jax.random.PRNGKey(1))
        states.append(jax.device_get(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def port_state(js):
    return train_state_from_flax(int(js.step), js.params, js.batch_stats, js.momentum,
                                 config=TrainConfig(**CFG), device="cpu")


def test_three_train_steps_match_jax(jax_run):
    states, metrics = jax_run
    cfg = TrainConfig(**CFG)
    lr, margin = schedule_values(cfg, START)
    assert lr > 0 and margin > 0
    step = make_train_step(cfg)
    for i, (feats, labels) in enumerate(batches(3)):
        # each step starts from the JAX side's state, so the JAX side's
        # float32 noise does not compound across the comparison
        state = port_state(states[i])
        state, m = step(state, torch.from_numpy(feats), torch.from_numpy(labels).long())
        assert state.step == START + i + 1
        assert set(m) == set(metrics[i])
        for k, v in metrics[i].items():
            assert_rel(float(m[k]), v, 20 * TOL if k == "gradient_norm" else TOL,
                       f"step {i} {k}")
        want = states[i + 1]
        for group, tree, got in (("params", want.params, state.params),
                                 ("batch_stats", want.batch_stats, state.batch_stats),
                                 ("momentum", want.momentum, state.momentum)):
            flat = from_flax({"params": tree} if group != "batch_stats" else {"batch_stats": tree},
                             projection=True)
            assert set(flat) == set(got), group
            for k, v in flat.items():
                assert_rel(got[k].detach().numpy(), v.numpy(),
                           {"momentum": 500 * TOL, "params": 10 * TOL}.get(group, TOL),
                           f"step {i} {group} {k}")


def test_train_step_gradient_matches_float64(jax_run):
    """One step from the same state in float32 and in float64 (the whole
    net, head and update): gradient norm and momentum (= the clipped
    gradient, from a zero trace) agree to 1e-4."""
    states, _ = jax_run
    cfg = TrainConfig(**CFG)
    feats, labels = next(batches(1))
    runs = []
    for dtype in (torch.float32, torch.float64):
        state = port_state(states[0])
        state.net.to(dtype)
        state.net.encoder.dtype = dtype
        state.momentum = {k: v.to(dtype) for k, v in state.momentum.items()}
        state, m = make_train_step(cfg)(state, torch.from_numpy(feats),
                                        torch.from_numpy(labels).long())
        runs.append((state, m))
    (s32, m32), (s64, m64) = runs
    assert_rel(float(m32["gradient_norm"]), float(m64["gradient_norm"]), TOL, "gnorm")
    for k, v in s64.momentum.items():
        assert_rel(s32.momentum[k].numpy(), v.numpy(), TOL, k)


def test_converted_state_gives_the_same_logits(jax_run):
    """A JAX create_train_state through train_state_from_flax: the same
    (eval-mode) embeddings and logits from the same inputs."""
    from voxsrc2020_speaker_verification_tpu.training import build_speaker_net as jax_net

    states, _ = jax_run
    js = states[0]
    feats, labels = next(batches(1, seed=3))
    net = jax_net(JaxConfig(**CFG))
    # jitted: op-by-op dispatch of the JAX net costs seconds of CPU
    apply = jax.jit(lambda v, f, y: net.apply(v, f, y, 32.0, 0.1, False))
    want_emb, want = apply({"params": js.params, "batch_stats": js.batch_stats},
                           jnp.asarray(feats[0]), jnp.asarray(labels[0]))
    state = port_state(js)
    with torch.no_grad():
        emb, got = state.net(torch.from_numpy(feats[0]), torch.from_numpy(labels[0]), 32.0, 0.1,
                             training=False)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=32e-4)
    # the encoder part is the serving net's state_dict, strict
    serve = build_speaker_net(TrainConfig(**CFG), "cpu")
    serve.load_state_dict({k: v for k, v in state.net.state_dict().items()
                           if not k.startswith("projection.")})


def test_train_cli_on_cpu(capsys):
    train_cli.main(["--recipe", "res2net_vox2_dev_aug", "--model", THIN, "--synthetic",
                    "--device", "cpu", "--batch-size", "4", "--num-accumulation-steps", "2",
                    "--feat-length", "24", "--max-steps", "2", "--no-checkpoint",
                    "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step 1/2 loss ") and "audio-s/s" in out[0]
    assert out[-1].startswith("done: 2 steps")
    # raw-audio training reads <data-root>/<dataset>/utt2id.pkl and wav.scp
    # (tests/test_torch_raw.py trains from them); rematerialization is ported
    with pytest.raises(FileNotFoundError, match="utt2id.pkl"):
        train_cli.main(["--recipe", "res2net_vox2_dev_aug", "--model", THIN, "--device", "cpu",
                        "--raw", "--data-root", "/nonexistent"])
    train_cli.main(["--recipe", "res2net_vox2_dev_aug", "--model", THIN, "--device", "cpu",
                    "--synthetic", "--remat-stages", "0", "--remat-policy", "dots_saveable",
                    "--batch-size", "4", "--feat-length", "24", "--max-steps", "1",
                    "--no-checkpoint"])
    assert capsys.readouterr().out.splitlines()[-1].startswith("done: 1 steps")


@pytest.mark.parametrize("flags", [["--num-processes", "2"], ["--process-id", "1"]])
def test_train_cli_refuses_more_than_one_process(flags, capsys):
    """More than one process needs its bootstrap: a second process without
    ``--coordinator``, or a process id outside the world (which would only
    shift the seed and name shards that do not exist), exits before any data
    is read. ``cli.launch`` passes the flags (tests/test_torch_parallel.py
    trains two processes through it)."""
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--recipe", "res2net_vox2_dev_aug", "--model", THIN, "--device", "cpu",
                        "--data-root", "/nonexistent", *flags])
    said = f"{exc.value} {capsys.readouterr().err}"
    assert ("--coordinator" if "--num-processes" in flags else "--process-id") in said


REMAT_CASES = {
    "every_block": dict(remat=True),
    "stage0": dict(remat=True, remat_stages=(0,)),
    "stages01_keep00": dict(remat=True, remat_stages=(0, 1), remat_keep_blocks=((0, 0),)),
    "dots_saveable": dict(remat=True, remat_policy="dots_saveable"),
}


def one_step(cfg, js, feats, labels):
    state = train_state_from_flax(int(js.step), js.params, js.batch_stats, js.momentum,
                                  config=cfg, device="cpu")
    step = make_train_step(cfg)
    return step(state, torch.from_numpy(feats), torch.from_numpy(labels).long())


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_step_equals_the_plain_step(jax_run, case):
    """A rematerialized step against the plain step from the same state: the
    BN running statistics bit-equal (the recomputed forward does not update
    them again), loss, gradient norm, momentum (the clipped gradient, from
    a zero trace) and parameters within 1e-6 of each tensor's largest
    magnitude."""
    states, _ = jax_run
    feats, labels = next(batches(1))
    plain, pm = one_step(TrainConfig(**CFG), states[0], feats, labels)
    remat, rm = one_step(TrainConfig(**CFG, **REMAT_CASES[case]), states[0], feats, labels)
    assert remat.net.encoder.blocks[0][2] == ((0, 0) not in (REMAT_CASES[case].get(
        "remat_keep_blocks") or ()))
    for k, v in plain.batch_stats.items():
        assert torch.equal(remat.batch_stats[k], v), k
    for k in ("loss", "gradient_norm", "accuracy"):
        assert_rel(float(rm[k]), float(pm[k]), 1e-6, k)
    for group in ("momentum", "params"):
        got, want = getattr(remat, group), getattr(plain, group)
        for k, v in want.items():
            assert_rel(got[k].detach().numpy(), v.detach().numpy(), 1e-6, f"{group} {k}")


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_step_matches_jax(jax_run, case):
    """The port's rematerialized step against the JAX package's step with
    the same remat options (jitted), from the same converted state, at the
    tolerances of test_three_train_steps_match_jax."""
    states, _ = jax_run
    feats, labels = next(batches(1))
    jcfg = JaxConfig(**CFG, **REMAT_CASES[case])
    jstate, jm = jax.jit(jax_step(jcfg))(jax.device_get(states[0]), jnp.asarray(feats),
                                          jnp.asarray(labels), jax.random.PRNGKey(1))
    want = jax.device_get(jstate)
    state, m = one_step(TrainConfig(**CFG, **REMAT_CASES[case]), states[0], feats, labels)
    for k, v in jm.items():
        assert_rel(float(m[k]), float(v), 20 * TOL if k == "gradient_norm" else TOL, k)
    for group, tree, got in (("params", want.params, state.params),
                             ("batch_stats", want.batch_stats, state.batch_stats),
                             ("momentum", want.momentum, state.momentum)):
        flat = from_flax({"params": tree} if group != "batch_stats" else {"batch_stats": tree},
                         projection=True)
        for k, v in flat.items():
            assert_rel(got[k].detach().numpy(), v.numpy(),
                       {"momentum": 500 * TOL, "params": 10 * TOL}.get(group, TOL),
                       f"{group} {k}")


def test_train_cli_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--recipe", "res2net_vox2_dev_aug", "--model", THIN, "--synthetic"])


def test_checkpoint_restore_and_lmft_tail(tmp_path):
    """Save/restore round trip, max_to_keep, and the LMFT contract: a state
    restored from the pretrain dir keeps its global step, so the schedule
    lands in the 1/128 LR tail."""
    cfg = TrainConfig(**CFG)
    state = create_train_state(cfg, "cpu", seed=1)
    step = make_train_step(cfg)
    mgr = CheckpointManager(str(tmp_path / "pre"), max_to_keep=2)
    for i, (feats, labels) in enumerate(batches(3)):
        state, _ = step(state, torch.from_numpy(feats), torch.from_numpy(labels).long())
        mgr.save(state)
    assert mgr.all_steps() == [2, 3]
    tail = cfg.epoch_size * cfg.lr_boundaries_epochs[-1] + 1
    state.step = tail
    mgr.save(state)

    fresh = create_train_state(cfg, "cpu", seed=2)
    fresh, new_mgr = restore_or_init(fresh, str(tmp_path / "ft"), resume_from=str(tmp_path / "pre"))
    assert fresh.step == tail and new_mgr.all_steps() == []
    for k, v in state.params.items():
        assert torch.equal(fresh.params[k], v)
    for k, v in state.momentum.items():
        assert torch.equal(fresh.momentum[k], v)
    for k, v in state.batch_stats.items():
        assert torch.equal(fresh.batch_stats[k], v)
    lr, _ = schedule_values(dataclasses.replace(cfg, margin=0.4), fresh.step)
    assert lr == pytest.approx(cfg.learning_rate / 128, rel=1e-6)


def test_init_weights_projection_is_seeded_orthogonal():
    """The sub-center kernel (K, emb, C) as jax.nn.initializers.orthogonal
    (column_axis=-1) makes it: the (K*emb, C) matrix has orthonormal rows."""
    from voxsrc2020_speaker_verification_tpu_torch.convert import init_weights

    cfg = TrainConfig(**CFG)
    a = init_weights(cfg, torch.Generator().manual_seed(4), projection=True)
    b = init_weights(cfg, torch.Generator().manual_seed(4), projection=True)
    k = a["projection.kernel"]
    assert k.shape == (2, 16, 16) and torch.equal(k, b["projection.kernel"])
    # 32 rows of 16: tall, so the columns are orthonormal
    m = k.reshape(-1, 16).double()
    torch.testing.assert_close(m.T @ m, torch.eye(16, dtype=torch.float64), atol=1e-6, rtol=0)
    wide = TrainConfig(**dict(CFG, num_classes=100))
    m = init_weights(wide, torch.Generator().manual_seed(4), projection=True)["projection.kernel"]
    m = m.reshape(-1, 100).double()
    torch.testing.assert_close(m @ m.T, torch.eye(32, dtype=torch.float64), atol=1e-6, rtol=0)
    assert "projection.kernel" not in init_weights(cfg, torch.Generator().manual_seed(4))
