"""PyTorch port, data preparation: the augmentation policies, MUSAN prep and
``cli.prepare_data`` stages 0-5 against the JAX package's on the CPU.

The corpus is tests/test_prepare.py's fixture corpus (two speakers of two
utterances, two simulated RIRs, a MUSAN tree with an annotated music dir),
here with ``rir_list`` metadata besides, so both reverb policies run.

Tolerances: every file the policies and stages 0-5 write besides the
features (wav.scp JSON specs, utt2spk, spk2utt, utt2dur, utt2num_frames,
spk, utt2id.pkl, the shards' scps, the MUSAN dirs, the downloaded and
assembled archives) byte for byte; the features of stages 4 and 5 one CM
quantum where both compress (the CLIs' format), and in plain stores 1e-4
in log-mel on white noise, 1e-2 on the corpus's pure tones (see
test_plain_features).
"""

import hashlib
import json
import os
import pickle
import stat
import sys

import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.cli import prepare_data as jprep
from voxsrc2020_speaker_verification_tpu.data import augment as jaugment
from voxsrc2020_speaker_verification_tpu.data import features as jfeatures
from voxsrc2020_speaker_verification_tpu.data import musan as jmusan
from voxsrc2020_speaker_verification_tpu_torch.cli import prepare_data as tprep
from voxsrc2020_speaker_verification_tpu_torch.data import audio, kaldi_io
from voxsrc2020_speaker_verification_tpu_torch.data import augment as taugment
from voxsrc2020_speaker_verification_tpu_torch.data import features as tfeatures
from voxsrc2020_speaker_verification_tpu_torch.data import musan as tmusan
from voxsrc2020_speaker_verification_tpu_torch.data import native as tnative
from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

torch.set_num_threads(1)

SR = 16000
TOL_FEATS = 1e-4
TOL_TONE = 1e-2


def _tone(freq, dur_s, amp=8000.0):
    t = np.arange(int(dur_s * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def write_corpus(root):
    """tests/test_prepare.py's corpus, with rir_list files for the rooms."""
    wavs = root / "wav"
    for spk in ("id001", "id002"):
        for i in range(2):
            d = wavs / spk / "vid"
            d.mkdir(parents=True, exist_ok=True)
            audio.write_wav(str(d / f"{i:05d}.wav"), _tone(200 + 50 * i, 0.6))
    rirs = root / "rirs" / "simulated_rirs"
    for room in ("smallroom", "mediumroom"):
        lines = []
        for r, peak in (("Room001", 3), ("Room002", 7)):
            d = rirs / room / r
            d.mkdir(parents=True)
            rir = np.zeros(128, np.float32)
            rir[peak] = 6000.0
            rir[peak + 5] = -1500.0
            audio.write_wav(str(d / "rir.wav"), rir)
            lines.append(f"--rir-id {room}-{r} --room-id {room}-{r} "
                         f"rirs/simulated_rirs/{room}/{r}/rir.wav")
        (rirs / room / "rir_list").write_text("\n".join(lines) + "\n")
    musan = root / "musan"
    for sub in ("noise", "speech"):
        d = musan / sub / "free-sound"
        d.mkdir(parents=True)
        for i in range(2):
            audio.write_wav(str(d / f"{sub}-{i}.wav"),
                            np.random.RandomState(i).randn(SR).astype(np.float32) * 800)
    md = musan / "music" / "fma"
    md.mkdir(parents=True)
    for i, _ in enumerate("NY"):
        audio.write_wav(str(md / f"music-{i}.wav"), _tone(100, 1.0, 600))
    with open(md / "ANNOTATIONS", "w") as f:
        f.write("music-0 rock N\nmusic-1 pop Y\n")
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"))


def read_dir(d):
    """{file name: bytes} of a data dir's files (not subdirs)."""
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, n))}


def assert_same_files(a, b, names=None):
    fa, fb = read_dir(a), read_dir(b)
    names = names or sorted(fa)
    assert names and set(names) <= set(fa) and set(names) <= set(fb), (sorted(fa), sorted(fb))
    for n in names:
        assert fa[n] == fb[n], n


class TestPolicies:
    def test_rir_machinery(self, corpus):
        lst = str(corpus / "rirs" / "simulated_rirs" / "smallroom" / "rir_list")
        assert (taugment.parse_rir_list(lst, base=str(corpus / "rirs"))
                == jaugment.parse_rir_list(lst, base=str(corpus / "rirs")))
        for probs, w in (([None, None], 0.0), ([0.8, None, None], 0.3), ([0.2, 0.5], 0.3)):
            assert taugment.smooth_probabilities(probs, w) == jaugment.smooth_probabilities(
                probs, w)
        rirs = jaugment.parse_rir_list(lst)
        assert taugment.make_room_dict(rirs) == jaugment.make_room_dict(rirs)

    @pytest.mark.parametrize("kind", ["reverb", "room_reverb", "noise", "music", "babble"])
    def test_policy_draws(self, corpus, kind):
        """1000 draws of each policy, the same specs in either package."""
        noises = {str(corpus / "musan" / "noise" / f"n{i}.wav"): 0.3 + 0.4 * i for i in range(5)}
        rooms = [(0.5, str(corpus / "rirs" / "simulated_rirs" / r / "rir_list"))
                 for r in ("smallroom", "mediumroom")]
        flat = [(0.5, [f"/r/small{i}.wav" for i in range(3)]), (0.5, ["/r/medium0.wav"])]

        def make(mod):
            return {"reverb": lambda: mod.ReverbPolicy(flat, seed=3),
                    "room_reverb": lambda: mod.RoomReverbPolicy(rooms, seed=3,
                                                                base=str(corpus / "rirs")),
                    "noise": lambda: mod.musan_noise_policy(noises, seed=4),
                    "music": lambda: mod.musan_music_policy(noises, seed=5),
                    "babble": lambda: mod.musan_babble_policy(noises, seed=6)}[kind]()

        tp, jp = make(taugment), make(jaugment)
        for i in range(1000):
            args = (f"/w/{i}.wav",) if "reverb" in kind else (f"/w/{i}.wav", 0.5 + i % 7)
            assert json.dumps(tp.sample(*args)) == json.dumps(jp.sample(*args)), i

    @pytest.mark.parametrize("rir_metadata", [False, True])
    def test_augment_stage(self, corpus, tmp_path, rir_metadata):
        """MUSAN dirs and the 5x dir (wav.scp JSON specs, utt2spk, spk2utt,
        labels) byte for byte, through both reverb policies."""
        rirs = tmp_path / "rirs"
        os.symlink(corpus / "rirs", rirs)
        if not rir_metadata:  # the flat-glob path: no rir_list files
            rirs = tmp_path / "rirs_flat"
            for room in ("smallroom", "mediumroom"):
                for r in ("Room001", "Room002"):
                    d = rirs / "simulated_rirs" / room / r
                    d.mkdir(parents=True)
                    os.symlink(corpus / "rirs" / "simulated_rirs" / room / r / "rir.wav",
                               d / "rir.wav")
        outs = {}
        for name, mod in (("jax", jprep), ("torch", tprep)):
            root = str(tmp_path / name)
            mod.create_dataset(str(corpus / "wav"), os.path.join(root, "dev"))
            outs[name] = (root, mod.augment_stage(root, "dev", str(corpus / "musan"),
                                                  str(rirs), seed=11))
        (jroot, jout), (troot, tout) = outs["jax"], outs["torch"]
        assert_same_files(jout, tout, ["spk", "spk2utt", "utt2id.pkl", "utt2spk", "wav.scp"])
        wav = datadir.read_two_column(os.path.join(tout, "wav.scp"))
        assert len(wav) == 4 * 5
        rv = json.loads(wav["id001-vid-00000-reverb"])
        assert rv["rir"] and os.path.exists(rv["rir"])
        for sub in ("music", "speech", "noise"):
            assert_same_files(os.path.join(jroot, f"musan_{sub}"),
                              os.path.join(troot, f"musan_{sub}"))
        assert_same_files(os.path.join(jroot, "dev"), os.path.join(troot, "dev"))


class TestMusan:
    def test_music_and_flat(self, corpus):
        root = str(corpus / "musan")
        for use_vocals in (False, True):
            assert tmusan.prepare_music(root, use_vocals) == jmusan.prepare_music(root, use_vocals)
        assert tmusan.prepare_flat(root, "noise") == jmusan.prepare_flat(root, "noise")
        ann = str(corpus / "musan" / "music" / "fma" / "ANNOTATIONS")
        assert tmusan.process_music_annotations(ann) == jmusan.process_music_annotations(ann)

    def test_data_dirs(self, corpus, tmp_path):
        t = tmusan.make_musan_data_dirs(str(corpus / "musan"), str(tmp_path / "t"))
        j = jmusan.make_musan_data_dirs(str(corpus / "musan"), str(tmp_path / "j"))
        assert sorted(t) == sorted(j) == ["music", "noise", "speech"]
        for sub in t:
            assert_same_files(j[sub], t[sub])
            assert tmusan.load_noise_durations(t[sub]) == jmusan.load_noise_durations(j[sub])


def read_feats(scp):
    return kaldi_io.read_all(kaldi_io.read_mat_scp(scp))


def cm_quantum(feats):
    """The coarsest step of Kaldi's CM compression over these matrices: the
    global range over 65535 (header) plus a column's percentile range over
    255 (the 8-bit codes), bounded by the whole range."""
    lo = min(float(m.min()) for m in feats.values())
    hi = max(float(m.max()) for m in feats.values())
    return (hi - lo) / 65535.0 + (hi - lo) / 255.0


class TestStages:
    """cli.prepare_data, both packages' CLIs on the same corpus. Both render
    the JSON specs with the Python renderer here (the JAX package's only
    one); the port's native renderer is held to it in
    test_native_renderer_on_the_specs."""

    @pytest.fixture(scope="class")
    def stages(self, corpus, tmp_path_factory):
        root = tmp_path_factory.mktemp("stages")
        dirs = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfeatures, "utterance_loader",
                       lambda: (taugment.load_utterance, "python"))
            for name, main, extra in (("jax", jprep.main, []),
                                      ("torch", tprep.main, ["--device", "cpu"])):
                data_root = str(root / name)
                common = ["--data-root", data_root, "--dataset", "dev", "--feat-dim", "40",
                          "--num-shards", "2", *extra]
                main(["--stage", "2", "--wav-root", str(corpus / "wav"), *common])
                main(["--stage", "4", *common])
                main(["--stage", "5", "--musan-root", str(corpus / "musan"),
                      "--rirs-root", str(corpus / "rirs"), *common])
                dirs[name] = data_root
        return dirs

    @pytest.mark.parametrize("dataset", ["dev", "dev_aug"])
    def test_dirs_match(self, stages, dataset):
        j, t = (os.path.join(stages[k], dataset) for k in ("jax", "torch"))
        names = ["spk", "spk2utt", "utt2id.pkl", "utt2num_frames", "utt2spk", "wav.scp"]
        assert_same_files(j, t, names + (["utt2dur"] if dataset == "dev" else []))
        assert datadir.validate_data_dir(t) == []
        for n in (1, 2):
            assert (open(os.path.join(j, "2-split", f"feats.{n}.scp")).read().replace(j, "")
                    == open(os.path.join(t, "2-split", f"feats.{n}.scp")).read().replace(t, ""))

    @pytest.mark.parametrize("dataset", ["dev", "dev_aug"])
    def test_features_match(self, stages, dataset):
        """The CLIs' CM-compressed stores agree to one CM quantum."""
        j, t = (read_feats(os.path.join(stages[k], dataset, "fbank40.scp"))
                for k in ("jax", "torch"))
        assert sorted(j) == sorted(t) and len(t) == (4 if dataset == "dev" else 20)
        q = cm_quantum(j)
        for u in j:
            assert j[u].shape == t[u].shape, u
            np.testing.assert_allclose(t[u], j[u], rtol=0, atol=q, err_msg=u)

    @pytest.mark.parametrize("dataset,tol", [("noise", TOL_FEATS), ("dev", TOL_TONE),
                                             ("dev_aug", TOL_TONE)])
    def test_plain_features(self, stages, corpus, dataset, tol, tmp_path):
        """The stages' featurizers, plain (uncompressed) stores: the port's
        K1 plain version against the JAX package's FBANK. ``noise`` is a
        data dir of the corpus's MUSAN noise wavs (white noise): 1e-4. The
        corpus's speech is pure tones, whose bins far from the tone hold
        ~1e-9 of its power: there float32 FBANK strays from float64 by up
        to 4.4e-3 in log-mel in either package, and the two differ by up
        to 5.0e-3 (TOL_TONE)."""
        outs = {}
        for name, fn, extra in (("jax", jfeatures.compute_features_for_dir, {}),
                                ("torch", tfeatures.compute_features_for_dir,
                                 {"device": "cpu"})):
            d = tmp_path / name
            if dataset == "noise":
                jprep.create_dataset(str(corpus / "musan" / "noise"), str(d))
            else:
                d.mkdir()
                for f in ("wav.scp", "utt2spk"):
                    os.symlink(os.path.join(stages[name], dataset, f), d / f)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tfeatures, "utterance_loader",
                           lambda: (taugment.load_utterance, "python"))
                outs[name] = read_feats(fn(str(d), 40, compress=False, **extra))
        assert sorted(outs["jax"]) == sorted(outs["torch"]) and outs["jax"]
        for u in outs["jax"]:
            np.testing.assert_allclose(outs["torch"][u], outs["jax"][u], rtol=0, atol=tol,
                                       err_msg=u)

    def test_native_renderer_on_the_specs(self, stages):
        """The port's default renderer where the native library builds (the
        C++ ``render_spec``) against the Python one on stage 5's specs:
        within 1e-2 in int16 scale (its float32 arithmetic against float64),
        as tests/test_torch_eval_cli.py holds it."""
        if not tnative.available():
            pytest.skip("the native library does not build here")
        wav = datadir.read_two_column(os.path.join(stages["torch"], "dev_aug", "wav.scp"))
        for u, v in sorted(wav.items()):
            a, sr = tnative.render_spec(v)
            b, sr_b = taugment.load_utterance(v)
            assert sr == sr_b and a.shape == b.shape, u
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-2, err_msg=u)


def _fake_tool(bindir, name, body):
    path = bindir / name
    path.write_text(f"#!{sys.executable}\n{body}")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


@pytest.fixture
def fake_path(tmp_path, monkeypatch):
    """A PATH whose ``wget`` copies local files (file:// URLs) and whose
    ``ffmpeg`` copies its input wav: no network, no real transcoder."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _fake_tool(bindir, "wget", """import os, shutil, sys
args = sys.argv[1:]
if "-O" in args:
    dst, url = args[args.index("-O") + 1], args[-1]
else:
    dst, url = os.path.join(args[args.index("-P") + 1], os.path.basename(args[-1])), args[-1]
shutil.copyfile(url[len("file://"):], dst)
""")
    _fake_tool(bindir, "ffmpeg", """import shutil, sys
args = sys.argv[1:]
shutil.copyfile(args[args.index("-i") + 1], args[-1])
""")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return bindir


class TestDownloadStages:
    def test_stage0_fake_wget(self, fake_path, tmp_path):
        src = tmp_path / "server"
        src.mkdir()
        for n in ("a.zip", "b.zip"):
            (src / n).write_bytes(os.urandom(64))
        (src / "list_test_T.txt").write_text("1 a b\n")
        urls = tmp_path / "urls.txt"
        urls.write_text("# archives\n" + "".join(f"file://{src / n}\n" for n in ("a.zip", "b.zip")))
        trials = tmp_path / "trials.txt"
        trials.write_text(f"file://{src / 'list_test_T.txt'} list_test_T.txt\n")
        for name, main in (("jax", jprep.main), ("torch", tprep.main)):
            main(["--stage", "0", "--url-manifest", str(urls), "--trials-manifest", str(trials),
                  "--archive-root", str(tmp_path / name / "arch"),
                  "--data-root", str(tmp_path / name / "data")])
        for sub in ("arch", os.path.join("data", "voxceleb1_trials")):
            assert_same_files(tmp_path / "jax" / sub, tmp_path / "torch" / sub)
        assert sorted(os.listdir(tmp_path / "torch" / "arch")) == ["a.zip", "b.zip"]

    def test_stage1_md5(self, tmp_path, capsys):
        arch = tmp_path / "arch"
        arch.mkdir()
        parts = tprep.ARCHIVE_PARTS["vox1_dev_wav.zip"]
        for i, p in enumerate(parts):
            (arch / p).write_bytes(bytes([i]) * 100)
        whole = b"".join(bytes([i]) * 100 for i in range(len(parts)))
        manifest = tmp_path / "md5.txt"
        manifest.write_text(f"{hashlib.md5(whole).hexdigest()} vox1_dev_wav.zip\n"
                            + "".join(f"{hashlib.md5(bytes([i]) * 100).hexdigest()} {p}\n"
                                      for i, p in enumerate(parts)))
        assert tprep.main(["--stage", "1", "--md5-manifest", str(manifest),
                           "--archive-root", str(arch)]) == str(arch)
        assert (arch / "vox1_dev_wav.zip").read_bytes() == whole
        assert "all archives verified" in capsys.readouterr().out
        (arch / "vox1_dev_wav.zip").write_bytes(b"corrupt")
        with pytest.raises(SystemExit) as e:
            tprep.main(["--stage", "1", "--md5-manifest", str(manifest),
                        "--archive-root", str(arch)])
        assert e.value.code == 1
        assert "vox1_dev_wav.zip" in capsys.readouterr().out
        # the JAX CLI agrees on the same verdict
        with pytest.raises(SystemExit):
            jprep.main(["--stage", "1", "--md5-manifest", str(manifest),
                        "--archive-root", str(arch)])

    def test_stage3_m4a(self, fake_path, corpus, tmp_path, monkeypatch):
        root = tmp_path / "m4a"
        (root / "id9" / "v").mkdir(parents=True)
        src = corpus / "wav" / "id001" / "vid" / "00000.wav"
        (root / "id9" / "v" / "00001.m4a").write_bytes(src.read_bytes())
        assert tprep.main(["--stage", "3", "--wav-root", str(root)]) == str(root)
        assert (root / "id9" / "v" / "00001.wav").read_bytes() == src.read_bytes()
        # no ffmpeg on PATH: an error, not a quiet skip
        (root / "id9" / "v" / "00001.wav").unlink()
        monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
        with pytest.raises(FileNotFoundError, match="ffmpeg"):
            tprep.main(["--stage", "3", "--wav-root", str(root)])

    def test_stage_arguments_are_required(self):
        for argv in (["--stage", "2"], ["--stage", "5"], ["--stage", "0"]):
            with pytest.raises(SystemExit) as e:
                tprep.main(argv)
            assert e.value.code not in (0, None)

    def test_manifests_are_the_packages_copies(self):
        jdir = os.path.dirname(jprep.DEFAULT_URLS)
        assert os.path.dirname(tprep.DEFAULT_URLS) != jdir
        for name in ("vox_urls.txt", "vox_md5.txt", "trials_urls.txt"):
            tp = os.path.join(os.path.dirname(tprep.DEFAULT_URLS), name)
            assert open(tp, "rb").read() == open(os.path.join(jdir, name), "rb").read()


def test_utt2id_labels(corpus, tmp_path):
    """write_labels: spk list and utt2id.pkl equal the JAX package's."""
    for name, mod in (("jax", jprep), ("torch", tprep)):
        mod.create_dataset(str(corpus / "wav"), str(tmp_path / name))
    with open(tmp_path / "jax" / "utt2id.pkl", "rb") as f, \
            open(tmp_path / "torch" / "utt2id.pkl", "rb") as g:
        assert pickle.load(f) == pickle.load(g)
