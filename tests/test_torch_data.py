"""PyTorch port, data layer: Kaldi table IO, data-dir utilities, the
feature-shard dataset and the native C++ feeder, each against the JAX
package's copy on the CPU.

Kaldi IO and data dirs must agree byte for byte (what one package writes,
the other writes identically and reads back identically); the dataset's
crops and labels exactly, from the same seed; the native feeder's batches
bit for bit, from the same seed with one worker thread (several threads
interleave their samples in arrival order), in float32 and on the bf16
wire, whose bits must equal ml_dtypes' rounding of the float32 batch.
"""

import io
import os
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.data import dataset as jds
from voxsrc2020_speaker_verification_tpu.data import kaldi_io as jkio
from voxsrc2020_speaker_verification_tpu.data import native as jnative
from voxsrc2020_speaker_verification_tpu.utils import datadir as jdd
from voxsrc2020_speaker_verification_tpu_torch.data import dataset as tds
from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io as tkio
from voxsrc2020_speaker_verification_tpu_torch.data import native as tnative
from voxsrc2020_speaker_verification_tpu_torch.utils import datadir as tdd

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not tnative.available(),
                                  reason="the native library does not build here")


def features(seed, t, f=8, offset=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, f) * 3 + offset + rng.randn(1, f) * 5).astype(np.float32)


@pytest.mark.parametrize("kind", ["fm", "dm", "cm", "fv", "dv"])
def test_writers_write_the_same_bytes(kind):
    """One entry through each package's writer: identical bytes, and each
    package's reader gives the same array back."""
    mat = features(1, 37, 13)
    arr = {"fm": mat, "dm": mat.astype(np.float64), "cm": mat,
           "fv": mat[0], "dv": mat[0].astype(np.float64)}[kind]
    bufs = []
    for kio in (jkio, tkio):
        buf = io.BytesIO()
        if kind.endswith("v"):
            kio.write_vec_flt(buf, arr, key="utt")
        else:
            kio.write_mat(buf, arr, key="utt", compress=kind == "cm")
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    reads = []
    for kio in (jkio, tkio):
        read = kio.read_vec_flt_ark if kind.endswith("v") else kio.read_mat_ark
        (key, got), = list(read(io.BytesIO(bufs[1])))
        assert key == "utt"
        reads.append(got)
    assert reads[0].dtype == reads[1].dtype
    np.testing.assert_array_equal(reads[0], reads[1])
    if kind != "cm":
        np.testing.assert_array_equal(reads[1], arr)


def write_store(kio, ark, scp, mats, compress):
    with kio.ArkScpWriter(ark, scp, compress=compress) as w:
        for key, m in mats.items():
            w.write(key, m)


@pytest.mark.parametrize("compress", [False, True], ids=["fm", "cm"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ark_scp_written_by_one_package_reads_in_the_other(tmp_path, writer, compress):
    """An ark,scp pair from either package's ArkScpWriter: the other
    package's files are byte-identical, and both read it back equal, through
    the ark, the scp (native decoder and Python reader) and a vector scp."""
    mats = {f"utt{i:03d}": features(i, 5 + 7 * i, 8) for i in range(6)}
    vecs = {k: m[0] for k, m in mats.items()}
    kio, other = (jkio, tkio) if writer == "jax" else (tkio, jkio)
    files = {}
    for name, k in (("a", kio), ("b", other)):
        ark, scp = str(tmp_path / f"{name}.ark"), str(tmp_path / f"{name}.scp")
        write_store(k, ark, scp, mats, compress)
        write_store(k, ark + "v", scp + "v", vecs, False)
        files[name] = (ark, scp)
    for ext in ("ark", "arkv"):
        assert open(files["a"][0] + ext[3:], "rb").read() == open(files["b"][0] + ext[3:],
                                                                  "rb").read()
    ark, scp = files["a"]
    for use_native in (True, False):
        want = dict(jkio.read_mat_scp(scp, use_native=use_native))
        got = dict(tkio.read_mat_scp(scp, use_native=use_native))
        assert list(got) == list(mats)
        for k in mats:
            np.testing.assert_array_equal(got[k], want[k])
    for k, v in tkio.read_mat_ark(ark):
        np.testing.assert_array_equal(v, dict(jkio.read_mat_ark(ark))[k])
    got_v = dict(tkio.read_vec_flt_scp(scp + "v"))
    for k, v in jkio.read_vec_flt_scp(scp + "v"):
        np.testing.assert_array_equal(got_v[k], v)
    if tnative.available():  # the native readers at the scp's offsets
        for (k, rx), (_, rxv) in zip(tkio._iter_scp(scp), tkio._iter_scp(scp + "v")):
            np.testing.assert_array_equal(tnative.read_mat(*tkio._split_rxfile(rx)),
                                          jnative.read_mat(*jkio._split_rxfile(rx)))
            np.testing.assert_array_equal(tnative.read_vec(*tkio._split_rxfile(rxv)), vecs[k])


def test_scp_offset_syntax(tmp_path):
    """'path:offset' rxfiles (and 'ark:' / 'scp:' prefixes) open at the
    entry, in both packages alike; the split of a plain entry is the same."""
    ark, scp = str(tmp_path / "x.ark"), str(tmp_path / "x.scp")
    with tkio.ArkScpWriter(ark, scp) as w:
        w.write("a", np.zeros((3, 4), np.float32))
        w.write("b", np.full((2, 4), 7, np.float32))
    (_, rx_a), (_, rx_b) = (line.split(maxsplit=1) for line in open(scp).read().splitlines())
    assert rx_b.startswith(os.path.abspath(ark) + ":")
    for rx in (rx_b, "ark:" + rx_b):
        with tkio.open_or_fd(rx) as fd:
            got = tkio.read_mat(fd)
        with jkio.open_or_fd(rx) as fd:
            np.testing.assert_array_equal(got, jkio.read_mat(fd))
        np.testing.assert_array_equal(got, np.full((2, 4), 7, np.float32))
    for rx in (rx_a, rx_b, "cmd |", "/no/offset"):
        assert tkio._split_rxfile(rx) == jkio._split_rxfile(rx)
    assert dict(tkio._iter_scp("scp:" + scp)) == dict(jkio._iter_scp(scp))


def test_datadir_utilities_match_jax(tmp_path):
    """utt2spk / spk2utt / wav.scp, utt2id, validate, fix, copy, subset and
    combine: the same files from both packages, byte for byte."""
    utt2spk = {f"spk{i}_utt{j}": f"spk{i}" for i in range(3) for j in range(4)}
    outs = {}
    for name, dd in (("jax", jdd), ("port", tdd)):
        d = tmp_path / name / "src"
        d.mkdir(parents=True)
        dd.write_two_column(str(d / "utt2spk"), utt2spk)
        dd.write_two_column(str(d / "wav.scp"), {u: f"/wav/{u}.wav" for u in list(utt2spk)[:-2]})
        dd.write_spk2utt(str(d / "spk2utt"), dd.utt2spk_to_spk2utt(utt2spk))
        problems = dd.validate_data_dir(str(d))
        dd.fix_data_dir(str(d))
        assert dd.validate_data_dir(str(d)) == []
        dd.copy_data_dir(str(d), str(tmp_path / name / "rev"), utt_suffix="-reverb")
        dd.subset_data_dir(str(d), str(tmp_path / name / "sub"), ["spk0_utt1", "spk2_utt0"])
        dd.combine_data_dirs(str(tmp_path / name / "all"),
                             [str(d), str(tmp_path / name / "rev")])
        utt2id = dd.build_utt2id(dd.read_two_column(str(d / "utt2spk")),
                                 sorted(set(utt2spk.values())))
        dd.save_utt2id(str(d / "utt2id.pkl"), utt2id)
        assert dd.load_utt2id(str(d / "utt2id.pkl")) == utt2id
        outs[name] = (problems, utt2id, {
            os.path.relpath(os.path.join(r, f), tmp_path / name): open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(tmp_path / name) for f in fs})
    assert outs["jax"] == outs["port"]
    assert outs["port"][0] == ["2 utts missing from wav.scp"]


@pytest.mark.parametrize("by_speaker", [False, True], ids=["lines", "speakers"])
def test_scp_sharding_matches_jax(tmp_path, by_speaker):
    """split_scp_lines(_by_speaker), shard_scp and shard_paths_for_host give
    the same shards in both packages."""
    rng = np.random.RandomState(7)
    utt2spk, lines = {}, []
    for s in range(9):
        for u in range(int(rng.randint(1, 12))):
            utt2spk[f"spk{s}_utt{u}"] = f"spk{s}"
            lines.append(f"spk{s}_utt{u} /x/{s}.ark:{u}")
    if by_speaker:
        assert (tdd.split_scp_lines_by_speaker(lines, 4, utt2spk)
                == jdd.split_scp_lines_by_speaker(lines, 4, utt2spk))
        with pytest.raises(ValueError):
            tdd.split_scp_lines_by_speaker(lines, 10, utt2spk)
    else:
        assert tdd.split_scp_lines(lines, 4) == jdd.split_scp_lines(lines, 4)
    shards = {}
    for name, dd in (("jax", jdd), ("port", tdd)):
        scp = tmp_path / name / "feats.scp"
        scp.parent.mkdir()
        scp.write_text("\n".join(lines) + "\n")
        paths = dd.shard_scp(str(scp), 4, utt2spk=utt2spk if by_speaker else None)
        shards[name] = [open(p).read() for p in paths]
    assert shards["jax"] == shards["port"]
    assert (tds.shard_paths_for_host("d", 8, 1, 2) == jds.shard_paths_for_host("d", 8, 1, 2)
            == [f"d/8-split/feats.{i}.scp" for i in (5, 6, 7, 8)])


def small_store(tmp_path, n=12, feat_dim=16, compress=True, lengths=(20, 120)):
    rng = np.random.RandomState(3)
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    utt2id = {}
    with tkio.ArkScpWriter(ark, scp, compress=compress) as w:
        for i in range(n):
            t = int(rng.randint(*lengths))
            w.write(f"utt{i:03d}", features(100 + i, t, feat_dim, offset=i))
            utt2id[f"utt{i:03d}"] = i % 4
    return ark, scp, utt2id


@pytest.mark.parametrize("cmvn", [False, True], ids=["sliding_cmn", "global_cmvn"])
def test_feature_shard_dataset_matches_jax(tmp_path, cmvn):
    """FeatureShardDataset (skip reshuffle, sliding CMN, global CMVN, crop or
    shifted zero pad) gives the JAX package's samples from the same seed,
    across the end of a pass; FeatureCropper alone does too."""
    _, scp, utt2id = small_store(tmp_path)
    pkl = None
    if cmvn:
        pkl = str(tmp_path / "cmvn.pkl")
        with open(pkl, "wb") as f:
            pickle.dump((np.linspace(-1, 1, 16).astype(np.float32),
                         np.linspace(1, 2, 16).astype(np.float32)), f)
    kw = dict(feat_dim=16, feat_length=50, cmvn_pkl=pkl, seed=5)
    got, want = iter(tds.FeatureShardDataset(scp, utt2id, **kw)), iter(
        jds.FeatureShardDataset(scp, utt2id, **kw))
    for _ in range(30):
        (gf, gl), (wf, wl) = next(got), next(want)
        assert gf.dtype == wf.dtype == np.float32 and gf.shape == (50, 16)
        np.testing.assert_array_equal(gf, wf)
        assert gl == wl and type(gl) is type(wl)
    feat = features(0, 30, 16)
    a = tds.FeatureCropper(50, 16, np.random.RandomState(1))
    b = jds.FeatureCropper(50, 16, np.random.RandomState(1))
    for f in (feat, features(1, 80, 16), feat):
        np.testing.assert_array_equal(a(f), b(f))
    # eval mode: one pass of whole utterances and their keys
    one = list(tds.FeatureShardDataset(scp, None, 16, 50, training=False))
    assert [k for _, k in one] == sorted(utt2id) and one[0][0].shape[1] == 16


@needs_native
@pytest.mark.parametrize("wire", ["float32", "bf16"])
def test_native_feeder_matches_jax(tmp_path, wire):
    """Both packages' NativeBatchFeeder over the same shards, one thread, the
    same seed: equal batches and labels, bit for bit. On the bf16 wire the
    port's batch is a torch.bfloat16 tensor whose bits equal the JAX
    feeder's ml_dtypes array and ml_dtypes' rounding of the float32 batch."""
    _, scp, utt2id = small_store(tmp_path)
    kw = dict(feat_dim=16, feat_length=50, batch_size=4, num_accumulation_steps=2,
              num_threads=1, seed=9)
    bf16 = wire == "bf16"
    feeders = [tnative.NativeBatchFeeder(scp, utt2id, wire_bf16=bf16, **kw),
               jnative.NativeBatchFeeder(scp, utt2id, wire_bf16=bf16, **kw),
               tnative.NativeBatchFeeder(scp, utt2id, **kw)]
    try:
        for _ in range(8):  # past the end of a pass
            (gf, gl), (wf, wl), (f32, _) = (f.get() for f in feeders)
            np.testing.assert_array_equal(gl, wl)
            if bf16:
                assert isinstance(gf, torch.Tensor) and gf.dtype == torch.bfloat16
                bits = gf.view(torch.int16).numpy()
                np.testing.assert_array_equal(bits, wf.view(np.int16))
                np.testing.assert_array_equal(bits, f32.astype(ml_dtypes.bfloat16).view(np.int16))
            else:
                assert gf.dtype == np.float32 and gf.shape == (2, 4, 50, 16)
                np.testing.assert_array_equal(gf, wf)
        assert all(f.decode_errors() == 0 and f.dead_shards() == 0 for f in feeders)
    finally:
        for f in feeders:
            f.close()
    assert feeders[0].decode_errors() == 0  # safe after close


@needs_native
def test_native_feeder_counts_a_corrupt_ark_and_a_dead_shard(tmp_path):
    """Two worker blocks of six entries: in the first, one entry's offset is
    corrupt (it counts in decode_errors and the block lives on); in the
    second, every matrix has the wrong feature dim (the block is dead after
    a full pass). The same counts as the JAX package's feeder."""
    _, scp, utt2id = small_store(tmp_path, n=6, compress=False)
    lines = open(scp).read().splitlines()
    key, rx = lines[0].split()
    path, off = rx.rsplit(":", 1)
    lines[0] = f"{key} {path}:{int(off) + 3}"  # 3 bytes past the binary marker
    good = tmp_path / "good.scp"
    good.write_text("\n".join(lines) + "\n")
    wrong = {f"bad{i}": features(i, 60, 19) for i in range(6)}
    write_store(tkio, str(tmp_path / "bad.ark"), str(tmp_path / "bad.scp"), wrong, False)
    utt2id.update({k: 0 for k in wrong})
    results = {}
    for name, mod in (("port", tnative), ("jax", jnative)):
        feeder = mod.NativeBatchFeeder([str(good), str(tmp_path / "bad.scp")], utt2id, 16, 50,
                                       2, num_threads=2, seed=1)
        try:
            for _ in range(200):
                feeder.get()
                if feeder.dead_shards():
                    break
            results[name] = (feeder.decode_errors() >= 7, feeder.dead_shards())
        finally:
            feeder.close()
    assert results["port"] == results["jax"] == (True, 1)
