"""PyTorch port, the evaluation leg: audio IO, the augmentation-spec
renderer, the FBANK store writer, the artifact converter and the export,
extract, score and evaluate CLIs, against the JAX package's on the CPU in
float32, from one JAX state of a thin Res2Net and the same numpy inputs.

Tolerances: wav samples and the native readers bit for bit; spec rendering
1e-4 relative to the signal's peak against JAX, 1e-2 absolute (int16
scale) native against Python (float64 vs float32 arithmetic); FBANK features 1e-3 in log-mel; embeddings 1e-4; trial scores
1e-5; printed EER and minDCF equal.

Every class makes its own files through fixtures; no test reads a file that
another test writes.
"""

import importlib.util
import json
import os
import pickle
import shutil
import wave

import jax
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.cli import evaluate as jevaluate
from voxsrc2020_speaker_verification_tpu.cli import extract as jextract
from voxsrc2020_speaker_verification_tpu.cli import score as jscore
from voxsrc2020_speaker_verification_tpu.data import audio as jaudio
from voxsrc2020_speaker_verification_tpu.data import augment as jaugment
from voxsrc2020_speaker_verification_tpu.data import features as jfeatures
from voxsrc2020_speaker_verification_tpu.eval.export import (
    export_inference_artifact as jax_export, load_inference_artifact as jax_load)
from voxsrc2020_speaker_verification_tpu.models import register_res2net_variant as jax_register
from voxsrc2020_speaker_verification_tpu.training import (
    TrainConfig as JaxConfig, create_train_state)
from voxsrc2020_speaker_verification_tpu_torch.cli import evaluate as tevaluate
from voxsrc2020_speaker_verification_tpu_torch.cli import export as texport
from voxsrc2020_speaker_verification_tpu_torch.cli import extract as textract
from voxsrc2020_speaker_verification_tpu_torch.cli import score as tscore
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.convert import train_state_from_flax
from voxsrc2020_speaker_verification_tpu_torch.data import audio as taudio
from voxsrc2020_speaker_verification_tpu_torch.data import augment as taugment
from voxsrc2020_speaker_verification_tpu_torch.data import features as tfeatures
from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
from voxsrc2020_speaker_verification_tpu_torch.data import native as tnative
from voxsrc2020_speaker_verification_tpu_torch.eval.export import load_inference_artifact
from voxsrc2020_speaker_verification_tpu_torch.eval.metrics import evaluate_trials
from voxsrc2020_speaker_verification_tpu_torch.eval.scoring import read_trials
from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import CheckpointManager
from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIN = "res2net50_thin_torch_eval"
THIN_KW = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
               width=(4, 8), split=4, output_dim=16)
jax_register(THIN, **THIN_KW)
register_res2net_variant(THIN, **THIN_KW)
CFG = JaxConfig(model=THIN, projection="sc_cm_linear", num_classes=6, num_centers=2,
                dataset_length=48, feat_dim=40, feat_length=32, batch_size=4,
                num_accumulation_steps=1, bf16=False, exp_root="")
SR = 16000
# seconds per utterance: three speakers; one utterance over 1000 frames
# (two chunks), one under the 25-frame minimum chunk
LENGTHS = {"spk0-a": 1.6, "spk0-b": 12.0, "spk1-a": 2.2, "spk1-b": 0.2,
           "spk2-a": 1.9, "spk2-b": 2.4}

needs_native = pytest.mark.skipif(not tnative.available(),
                                  reason="the native library does not build here")


def converter():
    spec = importlib.util.spec_from_file_location(
        "jax_artifact_to_torch", os.path.join(REPO, "scripts", "jax_artifact_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState of the thin model with BN statistics moved off 0/1."""
    state = create_train_state(CFG, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) + rng.randn(*v.shape).astype(np.float32) * 0.3
                      if "mean" in str(p[-1])
                      else np.asarray(v) * rng.uniform(0.5, 2.0, v.shape).astype(np.float32)),
        jax.device_get(state.batch_stats))
    return state.replace(batch_stats=stats)


@pytest.fixture(scope="module")
def artifacts(jax_state, tmp_path_factory):
    """(the JAX artifact, the port's artifact converted from it by
    scripts/jax_artifact_to_torch.py)."""
    root = tmp_path_factory.mktemp("artifacts")
    jax_dir = jax_export(CFG, jax_state, str(root / "jax"))
    assert converter().main([jax_dir, str(root / "port")]) == 0
    return jax_dir, str(root / "port")


def synth(seconds, seed, scale=2000.0):
    """A speaker-ish signal: a per-seed harmonic stack in noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 100 + 40 * (seed % 7)
    sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.rand()) / k for k in range(1, 6))
    return (scale * sig + 0.2 * scale * rng.randn(len(t))).astype(np.float32)


def write_rir(path, seed):
    rng = np.random.RandomState(seed)
    n = int(0.3 * SR)
    rir = rng.randn(n) * np.exp(-np.arange(n) / (0.04 * SR))
    rir[40] = 3.0  # the direct-path peak off index 0: exercises shift_output
    taudio.write_wav(path, (rir * 8000.0).astype(np.float32))


@pytest.fixture(scope="module")
def test_dir(tmp_path_factory):
    """A data dir of LENGTHS (one wav.scp entry a JSON reverb + noise spec),
    its uncompressed FBANK store written by the port, utt2spk, spk2utt and a
    trial list of every pair."""
    d = str(tmp_path_factory.mktemp("test") / "voxtest")
    os.makedirs(d)
    wav = {}
    for i, (utt, sec) in enumerate(sorted(LENGTHS.items())):
        path = os.path.join(d, f"{utt}.wav")
        taudio.write_wav(path, synth(sec, int(utt[3]) * 10 + i))
        wav[utt] = path
    write_rir(os.path.join(d, "rir.wav"), 5)
    taudio.write_wav(os.path.join(d, "noise.wav"), synth(1.0, 99, 500.0))
    wav["spk2-b"] = json.dumps({"source": wav["spk2-b"], "rir": os.path.join(d, "rir.wav"),
                                "noises": [{"path": os.path.join(d, "noise.wav"), "snr": 5,
                                            "start": 0, "extend": True}]},
                               separators=(",", ":"))
    datadir.write_two_column(os.path.join(d, "wav.scp"), wav)
    spk = {u: u.split("-")[0] for u in LENGTHS}
    datadir.write_two_column(os.path.join(d, "utt2spk"), spk)
    datadir.write_spk2utt(os.path.join(d, "spk2utt"),
                          {s: sorted(u for u in LENGTHS if spk[u] == s) for s in set(spk.values())})
    tfeatures.compute_features_for_dir(d, CFG.feat_dim, compress=False, device="cpu")
    utts = sorted(LENGTHS)
    with open(os.path.join(d, "trials"), "w") as f:
        for i, a in enumerate(utts):
            for b in utts[i + 1:]:
                f.write(f"{int(spk[a] == spk[b])} {a} {b}\n")
    return d


def vectors(scp):
    return dict(kaldi_io.read_vec_flt_scp(scp))


class TestAudio:
    def write(self, path, pcm, width, channels):
        with wave.open(path, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(width)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())

    @pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2)],
                             ids=["8bit", "16bit", "32bit", "16bit-stereo"])
    def test_read_wav_matches_jax(self, tmp_path, width, channels):
        rng = np.random.RandomState(width * 10 + channels)
        n = 3001 * channels
        pcm = {1: rng.randint(0, 256, n).astype(np.uint8),
               2: rng.randint(-32768, 32768, n).astype("<i2"),
               4: rng.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype("<i4")}[width]
        path = str(tmp_path / "x.wav")
        self.write(path, pcm, width, channels)
        want, sr = jaudio.read_wav(path)
        got, sr2 = taudio.read_wav(path)
        assert sr == sr2 == SR and got.dtype == np.float32 and len(got) == 3001
        np.testing.assert_array_equal(got, want)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(taudio.read_wav(f.read())[0], want)

    def test_write_wav_and_duration(self, tmp_path):
        path = str(tmp_path / "y.wav")
        x = np.random.RandomState(2).randn(8000).astype(np.float32) * 40000
        taudio.write_wav(path, x)
        jaudio.write_wav(str(tmp_path / "j.wav"), x)
        with open(path, "rb") as a, open(str(tmp_path / "j.wav"), "rb") as b:
            assert a.read() == b.read()
        assert taudio.wav_duration(path) == jaudio.wav_duration(path) == 0.5
        assert taudio.have_ffmpeg() == jaudio.have_ffmpeg()

    @needs_native
    @pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
    def test_native_read_wav_equals_python(self, tmp_path, channels):
        pcm = np.random.RandomState(channels).randint(-32768, 32768, 4000 * channels).astype("<i2")
        path = str(tmp_path / "z.wav")
        self.write(path, pcm, 2, channels)
        got, sr = tnative.read_wav(path)
        want, sr2 = taudio.read_wav(path)
        assert sr == sr2 and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        self.write(path, pcm.astype(np.uint8), 1, channels)
        with pytest.raises(IOError):
            tnative.read_wav(path)


class TestRender:
    @pytest.fixture(scope="class")
    def specs(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("render")
        src, noise, music = (str(d / f"{n}.wav") for n in ("src", "noise", "music"))
        taudio.write_wav(src, synth(2.5, 1))
        taudio.write_wav(noise, synth(0.7, 2, 800.0))
        taudio.write_wav(music, synth(1.3, 3, 600.0))
        write_rir(str(d / "rir.wav"), 4)
        specs = {
            "plain": src,
            "reverb": {"source": src, "rir": str(d / "rir.wav"), "noises": []},
            "noise": {"source": src, "rir": None, "noises": [
                {"path": noise, "snr": 10, "start": 4000}, {"path": noise, "snr": 5, "start": 30000}]},
            "music-extend": {"source": src, "rir": None, "noises": [
                {"path": music, "snr": 8, "start": 0, "extend": True}]},
            "reverb-and-babble": {"source": src, "rir": str(d / "rir.wav"), "noises": [
                {"path": music, "snr": 13, "extend": True}, {"path": noise, "snr": 17, "extend": True}]},
        }
        return {k: v if isinstance(v, str) else json.dumps(v, separators=(",", ":"))
                for k, v in specs.items()}

    def test_render_matches_jax(self, specs):
        for name, rx in specs.items():
            want, sr = jaugment.load_utterance(rx)
            got, sr2 = taugment.load_utterance(rx)
            assert sr == sr2 and len(got) == len(want) and got.dtype == np.float32, name
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)

    def test_dsp_pieces_match_jax(self):
        rng = np.random.RandomState(5)
        sig, rir, noise = rng.randn(3000), rng.randn(200), rng.randn(700)
        np.testing.assert_array_equal(taugment.extend_to_duration(noise, 2000),
                                      jaugment.extend_to_duration(noise, 2000))
        np.testing.assert_array_equal(taugment.reverberate(sig, rir), jaugment.reverberate(sig, rir))
        np.testing.assert_array_equal(taugment.add_noise(sig, noise, 7.0, 100),
                                      jaugment.add_noise(sig, noise, 7.0, 100))
        assert taugment.parse_spec(" /a/b.wav ") is None
        assert taugment.parse_spec('{"source": "x"}') == {"source": "x"}

    @needs_native
    def test_native_render_equals_python(self, specs):
        """A plain wav bit for bit; a spec within a hundredth of an int16
        quantum (the C++ renderer computes in float64 where the Python one
        rounds to float32: ~2e-3 measured on these signals)."""
        got, sr = tnative.render_spec(specs["plain"])
        want, sr2 = taugment.load_utterance(specs["plain"])
        assert sr == sr2
        np.testing.assert_array_equal(got, want)
        for name, rx in specs.items():
            got, _ = tnative.render_spec(rx)
            want, _ = taugment.load_utterance(rx)
            assert len(got) == len(want), name
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-2, err_msg=name)


class TestFeatures:
    @pytest.fixture(scope="class")
    def stores(self, test_dir, tmp_path_factory):
        """The test dir's wavs featurized by both packages, plain and
        CM-compressed, each into its own copy of the dir."""
        root = tmp_path_factory.mktemp("features")
        out = {}
        for name, fn, kw in (("jax", jfeatures.compute_features_for_dir, {}),
                             ("port", tfeatures.compute_features_for_dir, {"device": "cpu"})):
            for compress in (False, True):
                d = str(root / f"{name}-{compress}")
                shutil.copytree(test_dir, d)
                scp = fn(d, CFG.feat_dim, compress=compress, out_name="feats", batch_size=2, **kw)
                out[name, compress] = (d, dict(kaldi_io.read_mat_scp(scp)))
        return out

    def test_features_match_jax(self, stores):
        (jd, want), (td, got) = stores["jax", False], stores["port", False]
        assert sorted(got) == sorted(want) == sorted(LENGTHS)
        for utt in want:
            assert got[utt].shape == want[utt].shape, utt
            np.testing.assert_allclose(got[utt], want[utt], rtol=0, atol=1e-3, err_msg=utt)
        assert (datadir.read_two_column(os.path.join(td, "utt2num_frames"))
                == datadir.read_two_column(os.path.join(jd, "utt2num_frames")))
        # the 0.2 s utterance: 18 frames
        assert got["spk1-b"].shape == (18, CFG.feat_dim)

    def test_compressed_store(self, stores):
        """CM compression quantizes each column to 8 bits between its
        percentiles: the port's compressed store reads back within a quantum
        of its plain one, with the JAX store's shapes."""
        plain, packed = stores["port", False][1], stores["port", True][1]
        jax_packed = stores["jax", True][1]
        for utt, x in plain.items():
            assert packed[utt].shape == x.shape == jax_packed[utt].shape
            quantum = (x.max() - x.min()) / 255 * 2
            np.testing.assert_allclose(packed[utt], x, rtol=0, atol=quantum, err_msg=utt)

    def test_dither_is_refused(self, stores, tmp_path):
        """FBANK refuses a nonzero dither without its draws; featurization
        with a ``dither_seed`` draws them (dither 1.0) and writes a store of
        the undithered store's shapes, finite and not equal to it."""
        from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as tfb

        with pytest.raises(ValueError, match="dither"):
            tfb.fbank(torch.zeros(1, 1600), tfb.FbankConfig(dither=1.0))
        d = str(tmp_path / "dithered")
        shutil.copytree(stores["port", False][0], d)
        scp = tfeatures.compute_features_for_dir(d, CFG.feat_dim, compress=False,
                                                 out_name="dithered", batch_size=2,
                                                 dither_seed=1, device="cpu")
        got, plain = dict(kaldi_io.read_mat_scp(scp)), stores["port", False][1]
        assert sorted(got) == sorted(plain)
        for utt, x in plain.items():
            assert got[utt].shape == x.shape and np.isfinite(got[utt]).all(), utt
        assert any(not np.array_equal(got[u], x) for u, x in plain.items())

    def test_finalize_dataset_matches_jax(self, stores, tmp_path):
        dirs = {}
        for name in ("jax", "port"):
            d = str(tmp_path / name)
            shutil.copytree(stores[name, False][0], d)
            shutil.copyfile(os.path.join(stores["port", False][0], "feats.scp"),
                            os.path.join(d, f"fbank{CFG.feat_dim}.scp"))
            (jfeatures if name == "jax" else tfeatures).finalize_dataset(d, CFG.feat_dim, (2, 3))
            dirs[name] = d
        for f in ("spk", f"fbank{CFG.feat_dim}.scp", "utt2id.pkl",
                  "2-split/feats.1.scp", "3-split/feats.3.scp"):
            with open(os.path.join(dirs["jax"], f), "rb") as a, \
                    open(os.path.join(dirs["port"], f), "rb") as b:
                assert a.read() == b.read(), f


class TestConvertedArtifact:
    def test_embed_matches_jax(self, artifacts):
        jax_dir, port_dir = artifacts
        rng = np.random.RandomState(3)
        feats = rng.randn(3, 120, CFG.feat_dim).astype(np.float32)
        mask = np.ones((3, 120), np.float32)
        mask[1, 70:] = 0.0
        feats *= mask[..., None]
        _, jembed = jax_load(jax_dir)
        config, embed = load_inference_artifact(port_dir, "cpu")
        assert config.model == THIN
        np.testing.assert_allclose(embed(feats, mask).numpy(), np.asarray(jembed(feats, mask)),
                                   rtol=0, atol=1e-5)
        with open(os.path.join(jax_dir, "config.json")) as f, \
                open(os.path.join(port_dir, "config.json")) as g:
            assert json.load(f) == json.load(g)
        with open(os.path.join(jax_dir, "projection_weight.pkl"), "rb") as f, \
                open(os.path.join(port_dir, "projection_weight.pkl"), "rb") as g:
            np.testing.assert_array_equal(pickle.load(f), pickle.load(g))


def jax_extract(jax_dir, data_dir, out, *extra):
    jextract.main(["--artifact", jax_dir, "--data-dir", data_dir, "--out", out,
                   "--batch-size", "4", "--num-devices", "1", *extra])
    return vectors(out + ".scp")


def port_extract(port_dir, data_dir, out, *extra):
    scp = textract.main(["--artifact", port_dir, "--data-dir", data_dir, "--out", out,
                         "--batch-size", "4", "--device", "cpu", *extra])
    return vectors(scp)


class TestExtract:
    @pytest.fixture(scope="class")
    def runs(self, artifacts, test_dir, tmp_path_factory):
        jax_dir, port_dir = artifacts
        root = tmp_path_factory.mktemp("extract")
        out = {}
        for name, extra in (("host", ["--cmvn", "host"]), ("bf16", ["--wire", "bfloat16"]),
                            ("raw", ["--raw"])):
            out["jax", name] = jax_extract(jax_dir, test_dir, str(root / f"jax-{name}"), *extra)
        for name, extra in (("host", ["--cmvn", "host"]), ("device", ["--cmvn", "device"]),
                            ("bf16", ["--wire", "bfloat16"]), ("raw", ["--raw"])):
            out["port", name] = port_extract(port_dir, test_dir, str(root / f"port-{name}"),
                                             "--scp-name", "fbank40.scp", *extra)
        return out

    @pytest.mark.parametrize("port,jax_run", [("host", "host"), ("device", "host"),
                                              ("bf16", "bf16"), ("raw", "raw")])
    def test_vectors_match_jax(self, runs, port, jax_run):
        got, want = runs["port", port], runs["jax", jax_run]
        assert sorted(got) == sorted(want) == sorted(LENGTHS)
        for utt in want:
            assert got[utt].shape == (16,) and np.isfinite(got[utt]).all()
            np.testing.assert_allclose(got[utt], want[utt], rtol=0, atol=1e-4, err_msg=utt)

    def test_raw_equals_the_feature_store(self, runs):
        """--raw and the store the port wrote from the same wav.scp."""
        for utt, v in runs["port", "host"].items():
            np.testing.assert_allclose(runs["port", "raw"][utt], v, rtol=0, atol=1e-4)

    def test_cmvn_full_stream_batches(self):
        """Bucketed batches, padded tails and an utterance beyond the largest
        bucket all give the one-utterance result."""
        from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np

        rng = np.random.RandomState(4)
        stream = [(f"u{i}", rng.randn(t, 8).astype(np.float32) + 3)
                  for i, t in enumerate((40, 90, 33, 250, 12, 600))]
        # numpy rows (a feature store) and tensor rows (K1's output) alike
        for rows in (stream, [(u, torch.from_numpy(x)) for u, x in stream]):
            got = dict(textract.cmvn_full_stream(iter(rows), window=30, batch_size=2,
                                                 bucket_frames=(50, 100, 200), device="cpu"))
            assert sorted(got) == [u for u, _ in stream]
            for utt, x in stream:
                assert isinstance(got[utt], torch.Tensor) and got[utt].dtype == torch.float32
                np.testing.assert_allclose(got[utt].numpy(), sliding_cmn_np(x, 30),
                                           rtol=0, atol=2e-6)

    def test_device_cmvn_is_the_default(self):
        """Both CLIs run sliding CMVN where the features are (K7 on the card)
        unless --cmvn host asks for the host."""
        for parser, argv in ((textract.build_parser(), ["--artifact", "a", "--data-dir", "d",
                                                        "--out", "o"]),
                             (tevaluate.build_parser(), ["--artifact", "a", "--trials", "T"])):
            assert parser.parse_args(argv).cmvn == "device"
            assert parser.parse_args(argv + ["--cmvn", "host"]).cmvn == "host"

    def test_packed_tensor_chunks_equal_numpy_chunks(self):
        """Device-resident features pack where they lie, into the batch that
        numpy rows give, on either wire."""
        from voxsrc2020_speaker_verification_tpu_torch.eval.extract import pack_chunk_batch

        rng = np.random.RandomState(6)
        chunks = [(t, rng.randn(t, 5).astype(np.float32)) for t in (7, 3, 8)]
        for wire in (None, torch.bfloat16):
            f, m = pack_chunk_batch(chunks, 8, 5, wire)
            tf, tm = pack_chunk_batch([(t, torch.from_numpy(x)) for t, x in chunks], 8, 5, wire)
            assert tf.dtype == f.dtype and torch.equal(tf, f) and torch.equal(tm, m)


class TestScore:
    @pytest.fixture(scope="class")
    def xvectors(self, tmp_path_factory):
        """(test xvector scp, its trials, cohort xvector scp, cohort spk2utt):
        vectors from a seed, 5 test speakers x 4 utterances and 12 cohort
        speakers x 3, each speaker's vectors around its own direction."""
        d = tmp_path_factory.mktemp("score")
        rng = np.random.RandomState(8)

        def write(name, speakers, per):
            vecs = {f"{name}{s}-{i}": rng.randn(16) + 2.5 * centre
                    for s, centre in enumerate(rng.randn(speakers, 16)) for i in range(per)}
            with kaldi_io.ArkScpWriter(str(d / f"{name}.ark"), str(d / f"{name}.scp")) as w:
                for utt in sorted(vecs):
                    w.write(utt, vecs[utt].astype(np.float32))
            return sorted(vecs)

        utts = write("t", 5, 4)
        with open(d / "trials", "w") as f:
            for i, a in enumerate(utts):
                for b in utts[i + 1:]:
                    f.write(f"{int(a.split('-')[0] == b.split('-')[0])} {a} {b}\n")
        cohort = write("c", 12, 3)
        datadir.write_spk2utt(str(d / "spk2utt"),
                              {f"c{s}": [u for u in cohort if u.startswith(f"c{s}-")]
                               for s in range(12)})
        return str(d / "t.scp"), str(d / "trials"), str(d / "c.scp"), str(d / "spk2utt")

    @pytest.mark.parametrize("cohort", ["none", "speakers", "weights"])
    def test_score_matches_jax(self, artifacts, xvectors, tmp_path, capsys, cohort):
        jax_dir, port_dir = artifacts
        test_scp, trials, cohort_scp, spk2utt = xvectors
        args = ["--trials", trials, "--xvectors", test_scp]
        if cohort == "speakers":
            args += ["--cohort-xvectors", cohort_scp, "--cohort-spk2utt", spk2utt, "--topk", "5"]
        elif cohort == "weights":
            args += ["--topk", "5"]
        jargs = args + (["--cohort-weights", os.path.join(jax_dir, "projection_weight.pkl")]
                        if cohort == "weights" else [])
        targs = args + (["--cohort-weights", os.path.join(port_dir, "projection_weight.pkl")]
                        if cohort == "weights" else [])
        capsys.readouterr()
        jscore.main(jargs + ["--out", str(tmp_path / "jax.txt")])
        want_line = capsys.readouterr().out
        mode, eer, dcf = tscore.main(targs + ["--out", str(tmp_path / "port.txt"),
                                              "--device", "cpu"])
        got_line = capsys.readouterr().out
        assert got_line == want_line and mode == want_line.split(":")[0]
        got = np.loadtxt(tmp_path / "port.txt", dtype=str)
        want = np.loadtxt(tmp_path / "jax.txt", dtype=str)
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2].astype(float), want[:, 2].astype(float),
                                   rtol=0, atol=1e-5)
        # the printed numbers are eval/metrics of the scores file
        assert (eer, dcf) == evaluate_trials(read_trials(trials), got[:, 2].astype(float))

    def test_unlabelled_trials(self, xvectors, tmp_path, capsys):
        path = str(tmp_path / "pairs")
        with open(path, "w") as f:
            f.write("t0-0 t1-0\nt2-1 t2-3\n")
        assert tscore.main(["--trials", path, "--xvectors", xvectors[0], "--device", "cpu"]) == (
            "cosine", None, None)
        assert "scored 2 trials (no labels)" in capsys.readouterr().out


class TestEvaluate:
    @pytest.fixture(scope="class")
    def exp_dir(self, jax_state, tmp_path_factory):
        """A port experiment dir holding the JAX state as its checkpoint."""
        d = str(tmp_path_factory.mktemp("exp") / "run")
        js = jax.device_get(jax_state)
        config = TrainConfig(**{k: getattr(CFG, k) for k in TrainConfig.__dataclass_fields__})
        state = train_state_from_flax(int(js.step) + 7, js.params, js.batch_stats, js.momentum,
                                      config=config, device="cpu")
        CheckpointManager(d).save(state)
        config.to_json(os.path.join(d, "config.json"))
        return d

    def test_evaluate_from_exp_dir_matches_jax(self, artifacts, exp_dir, test_dir, tmp_path,
                                               capsys):
        jax_dir, _ = artifacts
        trials = os.path.join(test_dir, "trials")
        common = ["--test-dir", test_dir, "--cohort-dir", test_dir, "--trials", f"T={trials}",
                  "--topk", "2", "--batch-size", "4"]
        capsys.readouterr()
        jevaluate.main(["--artifact", jax_dir, "--out-dir", str(tmp_path / "jax"),
                        "--num-devices", "1", *common])
        want = capsys.readouterr().out.strip().splitlines()[-1]
        results = tevaluate.main(["--exp-dir", exp_dir, "--out-dir", str(tmp_path / "port"),
                                  "--device", "cpu", *common])
        out = capsys.readouterr().out
        assert "exporting" in out and out.strip().splitlines()[-1] == want
        assert set(results["T"]) == {"cosine", "asnorm"}
        # the export from the exp dir: the checkpoint's step, the JAX rows
        artifact = os.path.join(exp_dir, "artifact")
        with open(os.path.join(artifact, "config.json")) as f:
            assert json.load(f)["step"] == 7
        with open(os.path.join(jax_dir, "projection_weight.pkl"), "rb") as f, \
                open(os.path.join(artifact, "projection_weight.pkl"), "rb") as g:
            np.testing.assert_allclose(pickle.load(g), pickle.load(f), rtol=0, atol=1e-6)
        # a second run reuses the artifact and the xvectors, cosine only,
        # with a bare trial-set name under --data-root
        os.makedirs(tmp_path / "root" / "voxceleb1_trials")
        shutil.copyfile(trials, tmp_path / "root" / "voxceleb1_trials" / "list_test_T.txt")
        again = tevaluate.main(["--artifact", artifact, "--out-dir", str(tmp_path / "port"),
                                "--device", "cpu", "--test-dir", test_dir,
                                "--data-root", str(tmp_path / "root"), "--trials", "T"])
        assert "extracting" not in capsys.readouterr().out
        assert again["T"]["cosine"] == results["T"]["cosine"]

    def test_export_cli(self, exp_dir, tmp_path, capsys):
        out = texport.main(["--exp-dir", exp_dir, "--out", str(tmp_path / "a"), "--device", "cpu"])
        assert "(step 7)" in capsys.readouterr().out
        assert sorted(os.listdir(out)) == ["config.json", "projection_weight.pkl", "weights.pt"]
        with pytest.raises(SystemExit) as e:
            texport.main(["--exp-dir", exp_dir, "--stablehlo"])
        assert e.value.code != 0 and "ROADMAP.md" in str(e.value.code)
        with pytest.raises(SystemExit) as e:
            texport.main(["--exp-dir", str(tmp_path / "none"), "--device", "cpu"])
        assert e.value.code != 0


def test_more_than_one_device_is_refused(tmp_path, monkeypatch):
    """--num-devices beyond the cards present is an error, never a quiet
    fall back to fewer (here a one-card machine is pretended: the check
    comes before any device work)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for main, argv in ((textract.main, ["--artifact", "a", "--data-dir", "d", "--out", "o"]),
                       (tevaluate.main, ["--artifact", "a", "--trials", "T"])):
        with pytest.raises(ValueError, match="more cards than present"):
            main(argv + ["--num-devices", "2"])


def test_entry_points_default_to_the_card():
    """Without --device the CLIs ask for cuda; where there is none they raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        textract.main(["--artifact", "a", "--data-dir", "d", "--out", "o"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscore.main(["--trials", "t", "--xvectors", "x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.main(["--exp-dir", "e"])
