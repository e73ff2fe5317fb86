"""PyTorch port, ``cli.import_checkpoint``: a reference snapshot (an npz in
the oracle-dump format, and the same variables as a TF bundle written by
scripts/tf_bundle_writer.py) imported by the port's CLI and by the JAX
package's, from one JAX state of a thin Res2Net with non-trivial momentum
and a global step.

Tolerances: params, BN statistics and momentum bit for bit against the JAX
CLI's orbax checkpoint (through ``convert.from_flax``), the step equal;
the imported dir's artifact and extraction bit for bit against an artifact
saved straight from the original weights.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.cli import import_checkpoint as jimport
from voxsrc2020_speaker_verification_tpu.models import register_res2net_variant as jax_register
from voxsrc2020_speaker_verification_tpu.training import TrainConfig as JaxConfig
from voxsrc2020_speaker_verification_tpu.training import create_train_state as jax_create
from voxsrc2020_speaker_verification_tpu.training.checkpoint import (
    CheckpointManager as JaxManager)
from voxsrc2020_speaker_verification_tpu.utils.tf_import import (
    reference_var_map as jax_var_map)
from voxsrc2020_speaker_verification_tpu_torch.cli import export as texport
from voxsrc2020_speaker_verification_tpu_torch.cli import extract as textract
from voxsrc2020_speaker_verification_tpu_torch.cli import import_checkpoint as timport
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax
from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
from voxsrc2020_speaker_verification_tpu_torch.eval.export import save_inference_artifact
from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import CheckpointManager
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import tf_bundle_writer  # noqa: E402

torch.set_num_threads(1)

MODEL = "res2net_thin_torch_import"
THIN_KW = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2), width=(4, 8),
               split=4, output_dim=16)
jax_register(MODEL, **THIN_KW)
register_res2net_variant(MODEL, **THIN_KW)
STEP = 4321
CLASSES = 11
FEAT_DIM = 40


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """(the JAX state, its momentum, {tf name: array} with ``:0`` suffixes
    as oracle dumps carry them, the npz path, the bundle prefix)."""
    cfg = JaxConfig(model=MODEL, projection="sc_cm_linear", num_classes=CLASSES, num_centers=2,
                    dataset_length=64, feat_dim=FEAT_DIM, feat_length=32, batch_size=4,
                    num_accumulation_steps=1, bf16=False, exp_root="")
    state = jax.device_get(jax_create(cfg, jax.random.PRNGKey(7)))
    rng = np.random.RandomState(3)
    momentum = jax.tree.map(lambda p: rng.randn(*np.shape(p)).astype(np.float32), state.params)
    stats = jax.tree.map(lambda v: np.asarray(v) + rng.rand(*np.shape(v)).astype(np.float32),
                         state.batch_stats)
    snap = {}
    for tf_name, (col, path) in jax_var_map(MODEL).items():
        tree = state.params if col == "params" else stats
        snap[tf_name + ":0"] = _get(tree, ("encoder",) + path)
        if col == "params":
            snap[tf_name + "/Momentum:0"] = _get(momentum, ("encoder",) + path)
    snap["sc_cm_linear/kernel:0"] = _get(state.params, ("projection", "kernel"))
    snap["sc_cm_linear/kernel/Momentum:0"] = _get(momentum, ("projection", "kernel"))
    snap["global_step:0"] = np.asarray(STEP, np.int64)
    d = tmp_path_factory.mktemp("snapshot")
    npz = str(d / "ref_snapshot.npz")
    np.savez(npz, **snap)
    prefix = str(d / "tf" / f"model.ckpt-{STEP}")
    tf_bundle_writer.write_bundle(prefix, {k[:-2]: v for k, v in snap.items()})
    return {"params": state.params, "batch_stats": stats, "momentum": momentum}, npz, prefix


def port_state(exp, step=None):
    config = TrainConfig.from_json(os.path.join(exp, "config.json"))
    state = create_train_state(config, "cpu")
    assert CheckpointManager(exp).restore(state, step=step) is not None
    return config, state


def jax_import(npz, exp):
    jimport.main(["--npz", npz, "--model", MODEL, "--projection", "sc_cm_linear",
                  "--num-classes", str(CLASSES), "--exp-dir", exp, "--feat-dim", str(FEAT_DIM)])
    cfg = JaxConfig(model=MODEL, projection="sc_cm_linear", num_classes=CLASSES,
                    num_centers=2, feat_dim=FEAT_DIM, bf16=False, exp_root="")
    mgr = JaxManager(exp)
    restored = jax.device_get(mgr.restore(jax_create(cfg, jax.random.PRNGKey(0))))
    mgr.close()
    return restored


@pytest.mark.parametrize("source", ["npz", "ckpt"])
def test_roundtrip_matches_jax_cli(snapshot, tmp_path, source, capsys):
    want, npz, prefix = snapshot
    jstate = jax_import(npz, str(tmp_path / "jax"))
    exp = str(tmp_path / "port")
    timport.main([f"--{source}", npz if source == "npz" else prefix, "--model", MODEL,
                  "--projection", "sc_cm_linear", "--num-classes", str(CLASSES),
                  "--exp-dir", exp, "--feat-dim", str(FEAT_DIM), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"with momentum) at step {STEP}" in out
    if source == "ckpt":
        assert "MB/s, host" in out
    with open(os.path.join(exp, "config.json")) as f:
        written = json.load(f)
    assert (written["model"], written["num_classes"], written["feat_dim"]) == (
        MODEL, CLASSES, FEAT_DIM)
    assert CheckpointManager(exp).latest_step() == STEP
    _, state = port_state(exp)
    assert state.step == int(jstate.step) == STEP
    jflat = from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats},
                      projection=True)
    wflat = from_flax({"params": want["params"], "batch_stats": want["batch_stats"]},
                      projection=True)
    got = {**state.params, **state.batch_stats}
    assert got.keys() == jflat.keys()
    for k, v in got.items():
        assert torch.equal(v.detach(), jflat[k]), k
        assert torch.equal(v.detach(), wflat[k]), k
    jmom = from_flax({"params": jstate.momentum}, projection=True)
    assert state.momentum.keys() == jmom.keys()
    for k, v in state.momentum.items():
        assert torch.equal(v, jmom[k]), k
        assert v.abs().max() > 0, k


def test_without_slots_momentum_is_zero(snapshot, tmp_path):
    _, npz, prefix = snapshot
    data = np.load(npz)
    thin = {k[:-2]: data[k] for k in data.files if "/Momentum" not in k}
    thin_prefix = str(tmp_path / "thin" / "model.ckpt")
    tf_bundle_writer.write_bundle(thin_prefix, thin)
    exp = str(tmp_path / "exp")
    timport.main(["--ckpt", thin_prefix, "--model", MODEL, "--num-classes", str(CLASSES),
                  "--exp-dir", exp, "--step", "5", "--feat-dim", str(FEAT_DIM),
                  "--device", "cpu"])
    _, state = port_state(exp)
    assert state.step == 5
    assert all(float(m.abs().max()) == 0.0 for m in state.momentum.values())
    # and the step from global_step when --step is not given
    exp2 = str(tmp_path / "exp2")
    timport.main(["--ckpt", thin_prefix, "--model", MODEL, "--num-classes", str(CLASSES),
                  "--exp-dir", exp2, "--feat-dim", str(FEAT_DIM), "--device", "cpu"])
    assert port_state(exp2)[1].step == STEP


def test_imported_dir_exports_and_extracts(snapshot, tmp_path):
    """imported dir -> cli.export -> cli.extract on the CPU, bit for bit
    against an artifact saved from the original weights."""
    want, _, prefix = snapshot
    exp = str(tmp_path / "exp")
    timport.main(["--ckpt", prefix, "--model", MODEL, "--num-classes", str(CLASSES),
                  "--exp-dir", exp, "--feat-dim", str(FEAT_DIM), "--device", "cpu"])
    art = texport.main(["--exp-dir", exp, "--device", "cpu", "--batch-size", "16"])
    config = TrainConfig.from_json(os.path.join(exp, "config.json"))
    flat = from_flax({"params": want["params"], "batch_stats": want["batch_stats"]})
    direct = save_inference_artifact(config, flat, str(tmp_path / "direct"), step=STEP)
    w1 = torch.load(os.path.join(art, "weights.pt"), weights_only=True)
    w2 = torch.load(os.path.join(direct, "weights.pt"), weights_only=True)
    assert w1.keys() == w2.keys()
    assert all(torch.equal(w1[k], w2[k]) for k in w1)

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(2)
    with kaldi_io.ArkScpWriter(str(data / f"fbank{FEAT_DIM}.ark"),
                               str(data / f"fbank{FEAT_DIM}.scp")) as w:
        for i in range(7):
            w.write(f"u{i}", rng.randn(int(rng.randint(40, 700)), FEAT_DIM).astype(np.float32))
    out = {}
    for name, a in (("imported", art), ("direct", direct)):
        scp = textract.main(["--artifact", a, "--data-dir", str(data),
                             "--out", str(tmp_path / name), "--batch-size", "4",
                             "--device", "cpu"])
        out[name] = dict(kaldi_io.read_vec_flt_scp(scp))
    assert sorted(out["imported"]) == [f"u{i}" for i in range(7)]
    for u, v in out["imported"].items():
        assert v.shape == (16,) and np.isfinite(v).all()
        np.testing.assert_array_equal(v, out["direct"][u])
