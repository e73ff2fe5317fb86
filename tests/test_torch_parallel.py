"""PyTorch port, training across processes: the train step on gloo ranks of
a (data, model) layout (``parallel/``) against the same step in one process
on the same global batch, and against the JAX package's sharded step;
``cli.launch``; a checkpoint written by two ranks resumed in one process.

Every case runs in float32 on the CPU, torch held to one thread a process.
The ranks are ``torch.multiprocessing`` children that import this module
only, so it imports no JAX at the top (the JAX case imports it inside).
Tolerance rtol 2e-4, atol 1e-5: the loss, the gradient norm, every updated
parameter, the momentum and the BN running statistics (the tolerance of
JAX's tests/test_sharding_parity.py). Two ranks sum their BN moments and
gradients in another order than one process, so they agree to rounding,
not bit for bit.

Layouts: data 2 x model 1 at bn_groups 1 (each group spans both ranks), 2
(a group inside each rank) and 3 (groups that straddle the ranks' boundary)
on the thin Res2Net and the thin TDNN; data 1 x model 2 with the
sc_cm_linear head split into uneven class ranges (17 classes).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
from voxsrc2020_speaker_verification_tpu_torch.models.tdnn import register_tdnn_variant
from voxsrc2020_speaker_verification_tpu_torch.parallel import batch_spec, make_mesh
from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import (
    CheckpointManager, gather_full)
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
    create_train_state, make_train_step, shard_state)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5


# the ranks' bodies (each child process imports this module)

RES2NET_THIN = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
                    width=(4, 8), split=4, output_dim=16)
THIN = register_res2net_variant("res2net50_thin_torch_parallel", **RES2NET_THIN)
THIN_TDNN = register_tdnn_variant(
    "tdnn_thin_torch_parallel", block_filters=(16, 16, 16, 16, 48), output_dim=16)
START = 40  # a step where the LR is constant and the margin has started to grow


def global_batch(cfg: TrainConfig, seed: int = 0):
    """(features (A, B, T, F), labels (A, B)): zero-mean features, as
    tests/test_torch_trainer.py draws them."""
    rng = np.random.RandomState(seed)
    a, b = cfg.num_accumulation_steps, cfg.batch_size
    labels = rng.randint(0, cfg.num_classes, (a, b)).astype(np.int64)
    return rng.randn(a, b, cfg.feat_length, cfg.feat_dim).astype(np.float32), labels


def init(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)


def state_for(cfg: TrainConfig, mesh, start_state=None):
    """create_train_state at step START, or this rank's slices of a whole
    state ``{"model": state_dict, "momentum": ...}`` (a converted JAX state)."""
    state = create_train_state(cfg, "cpu", mesh=mesh)
    if start_state is not None:
        state.net.load_state_dict(shard_state(start_state["model"], mesh))
        state.momentum = shard_state(start_state["momentum"], mesh)
    state.step = START
    return state


def result(state, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": gather_full(state.params, state.mesh),
            "momentum": gather_full(state.momentum, state.mesh),
            "batch_stats": {k: v.clone() for k, v in state.batch_stats.items()}}


def run_step(rank, world, port, num_model, cfg_kw, out, start_path=None, ckpt_dir=None):
    """One step of ``TrainConfig(**cfg_kw)`` on ``world`` gloo ranks with
    ``num_model`` model ranks, each fed its rows of ``global_batch``; rank 0
    writes the result to ``out``; with ``ckpt_dir`` every rank then saves
    the state there (process 0 writes)."""
    init(rank, world, port)
    try:
        cfg = TrainConfig(**cfg_kw)
        mesh = make_mesh(num_model=num_model)
        start = torch.load(start_path, weights_only=True) if start_path else None
        state = state_for(cfg, mesh, start)
        feats, labels = global_batch(cfg)
        lo, hi = batch_spec(mesh, cfg.batch_size)
        state, metrics = make_train_step(cfg)(state, torch.from_numpy(feats[:, lo:hi]),
                                              torch.from_numpy(labels[:, lo:hi]))
        res = result(state, metrics)
        if ckpt_dir is not None:
            CheckpointManager(ckpt_dir).save(state)
        if rank == 0:
            torch.save(res, out)
        # every rank's logged metrics are the global batch's
        got = torch.tensor([res["metrics"]["loss"], res["metrics"]["gradient_norm"]])
        want = got.clone()
        dist.broadcast(want, 0)
        assert torch.equal(got, want), (rank, got, want)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args) -> None:
    """``fn(rank, world, port, *args)`` on ``world`` processes."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(fn, args=(world, port, *args), nprocs=world, join=True)


def one_process(cfg_kw, start=None, state=None):
    """The same step in one process on the whole batch."""
    torch.set_num_threads(1)
    cfg = TrainConfig(**cfg_kw)
    if state is None:
        state = state_for(cfg, None, start)
    feats, labels = global_batch(cfg)
    state, metrics = make_train_step(cfg)(state, torch.from_numpy(feats),
                                          torch.from_numpy(labels))
    return result(state, metrics)


def thin_config(model: str = THIN, **kw) -> dict:
    base = dict(model=model, projection="sc_cm_linear", num_classes=17, num_centers=2,
                dataset_length=160, feat_dim=16, feat_length=24, batch_size=12,
                num_accumulation_steps=2, bn_groups=2, bf16=False, exp_root="")
    return {**base, **kw}


def assert_same_step(got, want, what=""):
    for k in ("loss", "classification_loss", "regularization_loss", "accuracy",
              "gradient_norm", "learning_rate", "margin"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")
    for group in ("params", "momentum", "batch_stats"):
        assert set(got[group]) == set(want[group]), group
        for k, v in want[group].items():
            assert got[group][k].shape == v.shape, (group, k)
            np.testing.assert_allclose(got[group][k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {group} {k}")


def two_ranks(tmp_path, num_model, cfg, **kw):
    out = str(tmp_path / "rank0.pt")
    spawn(run_step, 2, num_model, cfg, out, kw.get("start_path"),
                kw.get("ckpt_dir"))
    return torch.load(out, weights_only=True)


@pytest.mark.parametrize("model,groups", [
    (THIN, 1), (THIN, 2), (THIN, 3),
    (THIN_TDNN, 1), (THIN_TDNN, 2), (THIN_TDNN, 3)])
def test_data_sharded_step_matches_one_process(tmp_path, model, groups):
    """Two data ranks, six rows each, against one process on the twelve:
    BN groups that span the ranks (1, and 3: groups of four rows, the middle
    one straddling the ranks), and groups inside each rank (2)."""
    cfg = thin_config(model, bn_groups=groups)
    assert_same_step(two_ranks(tmp_path, 1, cfg), one_process(cfg),
                     f"{model} bn_groups {groups}")


@pytest.mark.parametrize("projection", ["sc_cm_linear", "cm_linear_voxsrc2020", "hcm_linear",
                                        "linear"])
def test_model_sharded_step_matches_one_process(tmp_path, projection):
    """Two model ranks holding classes 0-8 and 9-16 of a 17-class head, on
    the same rows, against one process with the whole head: the head's
    gradient, norm and l2 term count each shard once. sc_cm_linear takes
    K6's class-sharded mode (a partial log-sum-exp), the other heads their
    logits gathered whole (hcm_linear's hard margin compares every class
    with the label's)."""
    cfg = thin_config(bn_groups=2, projection=projection)
    assert_same_step(two_ranks(tmp_path, 2, cfg), one_process(cfg),
                     f"model 2 {projection}")


def test_sharded_step_matches_jax(tmp_path):
    """The port on two model ranks against the JAX package's jitted
    ``make_train_step`` under ``make_mesh(num_data=2, num_model=2)`` on four
    of the suite's eight virtual CPU devices (GSPMD), from one converted
    state and one global batch."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from voxsrc2020_speaker_verification_tpu.models import register_res2net_variant
    from voxsrc2020_speaker_verification_tpu.parallel import (
        batch_spec, make_mesh, param_shardings)
    from voxsrc2020_speaker_verification_tpu.training import (
        TrainConfig as JaxConfig, create_train_state, make_train_step)
    from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax

    register_res2net_variant(THIN, **RES2NET_THIN)
    cfg = thin_config(num_classes=16, bn_groups=2)
    jcfg = dataclasses.replace(JaxConfig(**cfg), num_model_shards=2)
    mesh = make_mesh(num_data=2, num_model=2, devices=jax.devices()[:4])
    state = create_train_state(jcfg, jax.random.PRNGKey(0)).replace(step=jnp.int32(START))
    start = jax.device_get(state)
    shardings = param_shardings(mesh, jax.eval_shape(lambda: state))
    data = NamedSharding(mesh, batch_spec())
    step = jax.jit(make_train_step(jcfg), in_shardings=(shardings, data, data, None),
                   out_shardings=(shardings, None))
    feats, labels = global_batch(TrainConfig(**cfg))
    new, metrics = step(jax.device_put(state, shardings), feats, labels.astype(np.int32),
                        jax.random.PRNGKey(1))
    new = jax.device_get(new)
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": from_flax({"params": new.params}, projection=True),
            "momentum": from_flax({"params": new.momentum}, projection=True),
            "batch_stats": from_flax({"batch_stats": new.batch_stats}, projection=True)}
    start_path = str(tmp_path / "start.pt")
    torch.save({"model": from_flax({"params": start.params, "batch_stats": start.batch_stats},
                                   projection=True),
                "momentum": from_flax({"params": start.momentum}, projection=True)}, start_path)
    got = two_ranks(tmp_path, 2, cfg, start_path=start_path)
    assert_same_step(got, want, "port model 2 vs JAX 2 x 2")


def test_checkpoint_from_two_ranks_resumes_in_one_process(tmp_path):
    """Two model ranks save their state (the head gathered whole, process 0
    writing); one process restores it (every tensor as the ranks held it),
    its next step equals one process's second step, and cli.export reads the
    checkpoint."""
    from voxsrc2020_speaker_verification_tpu_torch.cli import export as export_cli

    cfg = thin_config(bn_groups=3)
    exp = tmp_path / "exp"
    got = two_ranks(tmp_path, 2, cfg, ckpt_dir=str(exp))
    config = TrainConfig(**cfg)
    state = create_train_state(config, "cpu")
    assert CheckpointManager(str(exp)).restore(state) is not None
    assert state.step == START + 1
    for k, v in got["params"].items():
        assert torch.equal(state.params[k].detach(), v), k
    for k, v in got["momentum"].items():
        assert torch.equal(state.momentum[k], v), k
    # the next step, on a second batch, from the restored state and from
    # one process's own first step
    feats, labels = global_batch(config, seed=1)
    one = one_process(cfg)
    ref = create_train_state(config, "cpu")
    with torch.no_grad():
        for k, p in ref.params.items():
            p.copy_(one["params"][k])
        for k, b in ref.batch_stats.items():
            b.copy_(one["batch_stats"][k])
    ref.momentum = {k: v.clone() for k, v in one["momentum"].items()}
    ref.step = START + 1
    results = []
    for s in (state, ref):
        s, m = make_train_step(config)(s, torch.from_numpy(feats), torch.from_numpy(labels))
        results.append(result(s, m))
    assert_same_step(results[0], results[1], "resumed step")
    config.to_json(str(exp / "config.json"))
    export_cli.main(["--exp-dir", str(exp), "--device", "cpu"])
    assert os.path.exists(exp / "artifact")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("recipe,model,model_shards", [
    ("res2net_vox2_dev_aug", "res2net50_w8_s6_c16", 1),
    ("res2net_vox2_dev_aug", "res2net50_w8_s6_c16", 2),
    ("tdnn_voxsrc2020_vox2_dev", "tdnn", 2)])
def test_launch_two_processes(tmp_path, recipe, model, model_shards):
    """cli.launch spawns two cli.train processes on the CPU (gloo), as
    JAX's tests/test_launch_distributed.py does: both finish their two
    steps and print the same loss; rank 1 logs to launch_rank1.log; only
    process 0 writes the experiment dir's metrics."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "voxsrc2020_speaker_verification_tpu_torch.cli.launch",
         "--num-processes", "2", "--coordinator", f"127.0.0.1:{_free_port()}", "--",
         "--recipe", recipe, "--model", model,
         "--synthetic", "--device", "cpu", "--num-model-shards", str(model_shards),
         "--batch-size", "4", "--num-accumulation-steps", "1", "--feat-length", "24",
         "--max-steps", "2", "--log-every", "1", "--num-workers", "1",
         "--exp-root", str(tmp_path / "exp"), "--num-classes", "10"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: 2 steps" in proc.stdout and "distributed: gloo" in proc.stdout
    rank1 = (tmp_path / "launch_rank1.log").read_text()
    assert "done: 2 steps" in rank1
    line0 = [l for l in proc.stdout.splitlines() if l.startswith("step 2/")][0]
    line1 = [l for l in rank1.splitlines() if l.startswith("step 2/")][0]
    assert line0.split("loss")[1].split()[0] == line1.split("loss")[1].split()[0]
    from voxsrc2020_speaker_verification_tpu_torch.utils.observability import load_metrics
    exp_dirs = [d for d, _, files in os.walk(tmp_path / "exp") if "metrics.jsonl" in files]
    assert len(exp_dirs) == 1 and [r["step"] for r in load_metrics(exp_dirs[0])] == [1, 2]
