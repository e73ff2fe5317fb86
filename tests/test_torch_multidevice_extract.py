"""PyTorch port, extraction over several devices (``--num-devices``): one
process drives a replica of the artifact a device, each bucket batch split
into contiguous row blocks. On the CPU the devices are CPU replicas.

Against one device: each replica runs the one-device forward on its block,
so the sharded extraction equals one device running batches of the block's
size bit for bit; against one device at the whole batch it agrees to
float32 rounding (PyTorch's CPU GEMMs block by the row count, so the same
row's sums can round apart at another batch size: 1e-6 here). Against the
JAX package's 8-device mesh extraction of tests/test_multidevice_extract.py
(its 21-utterance mix, 1000 and 1400 frames among them): 1e-5.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from voxsrc2020_speaker_verification_tpu.eval.export import (
    export_inference_artifact as jax_export, load_inference_artifact as jax_load)
from voxsrc2020_speaker_verification_tpu.eval.extract import (
    extract_embeddings as jax_extract, make_bucketed_embed_fn as jax_bucketed)
from voxsrc2020_speaker_verification_tpu.training import TrainConfig as JaxConfig
from voxsrc2020_speaker_verification_tpu.training import create_train_state
from voxsrc2020_speaker_verification_tpu_torch.cli import evaluate as tevaluate
from voxsrc2020_speaker_verification_tpu_torch.cli import export as texport
from voxsrc2020_speaker_verification_tpu_torch.cli import extract as textract
from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
from voxsrc2020_speaker_verification_tpu_torch.eval import extract as textr
from voxsrc2020_speaker_verification_tpu_torch.eval.export import (
    load_inference_artifact, load_sharded_inference_artifact)
from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = JaxConfig(model="tdnn", projection="sc_cm_linear", num_classes=6, num_centers=2,
                dataset_length=48, feat_dim=40, feat_length=32, batch_size=4,
                num_accumulation_steps=1, bf16=False, exp_root="")
TOL_JAX = dict(rtol=1e-5, atol=1e-6)
TOL_WHOLE_BATCH = dict(rtol=0, atol=1e-6)


def converter():
    spec = importlib.util.spec_from_file_location(
        "jax_artifact_to_torch", os.path.join(REPO, "scripts", "jax_artifact_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(JAX artifact, the port's converted from it)."""
    state = create_train_state(CFG, jax.random.PRNGKey(0))
    root = tmp_path_factory.mktemp("exp")
    jax_dir = jax_export(CFG, state, str(root / "jax"))
    assert converter().main([jax_dir, str(root / "port")]) == 0
    return jax_dir, str(root / "port")


def features(n=21, seed=0):
    """tests/test_multidevice_extract.py's mix: lengths over the chunk
    buckets, one of 1000 frames and one of 1400 (two chunks)."""
    rng = np.random.RandomState(seed)
    lengths = [int(rng.randint(30, 400)) for _ in range(n - 2)] + [1000, 1400]
    return [(f"utt{i}", rng.randn(t, CFG.feat_dim).astype(np.float32))
            for i, t in enumerate(lengths)]


def port_extract(artifact, devices, batch_size, feats):
    _, embed = load_sharded_inference_artifact(artifact, devices)
    return textr.extract_embeddings(textr.make_bucketed_embed_fn(embed, batch_size),
                                    iter(feats), batch_size=batch_size)


def test_three_cpu_replicas_equal_one_device(artifacts):
    feats = features()
    sharded = port_extract(artifacts[1], ["cpu"] * 3, 48, feats)
    block = port_extract(artifacts[1], ["cpu"], 16, feats)
    whole = port_extract(artifacts[1], ["cpu"], 48, feats)
    assert set(sharded) == set(block) == set(whole) == {u for u, _ in feats}
    for u in sharded:
        np.testing.assert_array_equal(sharded[u], block[u], err_msg=u)
        np.testing.assert_allclose(sharded[u], whole[u], err_msg=u, **TOL_WHOLE_BATCH)


def test_matches_jax_mesh_extraction(artifacts):
    assert jax.device_count() == 8
    feats = features()
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    _, embed8 = jax_load(artifacts[0], mesh=mesh)
    want = jax_extract(jax_bucketed(embed8, batch_size=16), iter(feats), batch_size=16)
    for devices, batch in ((["cpu"] * 3, 18), (["cpu"] * 8, 16), (["cpu"], 16)):
        got = port_extract(artifacts[1], devices, batch, feats)
        assert set(got) == set(want)
        for u in want:
            np.testing.assert_allclose(got[u], want[u], err_msg=f"{len(devices)}: {u}",
                                       **TOL_JAX)


def test_sharded_embed_splits_rows_in_order(artifacts):
    _, one = load_inference_artifact(artifacts[1], "cpu")
    calls = []

    def spy(i):
        def fn(f, m):
            calls.append((i, f.shape[0]))
            return one(f, m)
        return fn

    embed = textr.sharded_embed_fn([spy(i) for i in range(3)])
    x = torch.from_numpy(np.random.RandomState(1).randn(12, 64, 40).astype(np.float32))
    m = torch.ones(12, 64)
    m[5:, 40:] = 0
    got = embed(x, m)
    assert calls == [(0, 4), (1, 4), (2, 4)]
    want = torch.cat([one(x[i:i + 4], m[i:i + 4]) for i in (0, 4, 8)])
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not split over 3"):
        embed(x[:10], m[:10])


@pytest.mark.parametrize("batch,n,want", [(16, 1, 16), (16, 3, 18), (64, 4, 64), (5, 8, 8),
                                          (128, 3, 129)])
def test_round_up_rule(batch, n, want):
    assert textr.round_up_batch(batch, n) == want


def test_device_lists(monkeypatch):
    assert textr.extraction_devices(0, "cpu") == [torch.device("cpu")]
    assert textr.extraction_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        textr.extraction_devices(-1, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert textr.extraction_devices(0) == [torch.device("cuda", i) for i in range(4)]
    assert textr.extraction_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert textr.extraction_devices(1, "cuda:3") == [torch.device("cuda:3")]
    with pytest.raises(ValueError, match="more cards than present"):
        textr.extraction_devices(5)
    with pytest.raises(ValueError, match="takes cuda:0"):
        textr.extraction_devices(2, "cuda:1")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("store") / "test"
    d.mkdir()
    rng = np.random.RandomState(2)
    with kaldi_io.ArkScpWriter(str(d / "fbank40.ark"), str(d / "fbank40.scp")) as w:
        for i in range(9):
            w.write(f"spk{i % 3}-u{i}",
                    rng.randn(int(rng.randint(40, 1200)), 40).astype(np.float32))
    utts = [f"spk{i % 3}-u{i}" for i in range(9)]
    datadir.write_two_column(str(d / "utt2spk"), {u: u.split("-")[0] for u in utts})
    with open(d / "trials.txt", "w") as f:
        for a in utts:
            for b in utts:
                if a < b:
                    f.write(f"{int(a.split('-')[0] == b.split('-')[0])} {a} {b}\n")
    return str(d)


def test_extract_cli_num_devices(artifacts, store, tmp_path):
    """cli.extract --num-devices 3 --batch-size 16 (rounded up to 18) writes
    the ark/scp of one device at batches of 6, bit for bit."""
    out = {}
    for name, argv in (("three", ["--num-devices", "3", "--batch-size", "16"]),
                       ("one", ["--num-devices", "1", "--batch-size", "6"]),
                       ("default", [])):
        scp = textract.main(["--artifact", artifacts[1], "--data-dir", store,
                             "--out", str(tmp_path / name), "--device", "cpu", *argv])
        out[name] = dict(kaldi_io.read_vec_flt_scp(scp))
    assert len(out["three"]) == 9
    for u in out["one"]:
        np.testing.assert_array_equal(out["three"][u], out["one"][u], err_msg=u)
        np.testing.assert_allclose(out["three"][u], out["default"][u], err_msg=u,
                                   **TOL_WHOLE_BATCH)


def test_evaluate_cli_num_devices(artifacts, store, tmp_path):
    res = {}
    for n in ("2", "1"):
        res[n] = tevaluate.main(["--artifact", artifacts[1], "--test-dir", store,
                                 "--trials", f"T={os.path.join(store, 'trials.txt')}",
                                 "--out-dir", str(tmp_path / n), "--device", "cpu",
                                 "--num-devices", n, "--batch-size", "8"])
    assert res["2"]["T"]["cosine"] == pytest.approx(res["1"]["T"]["cosine"], abs=1e-6)


def test_export_cli_batch_size(artifacts, tmp_path):
    """The JAX command line's --batch-size is accepted; --stablehlo still
    exits with its error."""
    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
    from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import create_train_state \
        as port_state

    config = TrainConfig(model="tdnn", num_classes=6, feat_dim=40, bf16=False)
    exp = str(tmp_path / "exp")
    CheckpointManager(exp).save(port_state(config, "cpu"), step=3)
    config.to_json(os.path.join(exp, "config.json"))
    out = texport.main(["--exp-dir", exp, "--batch-size", "64", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["config.json", "projection_weight.pkl", "weights.pt"]
    with pytest.raises(SystemExit) as e:
        texport.main(["--exp-dir", exp, "--batch-size", "64", "--stablehlo"])
    assert "not ported" in str(e.value.code)
