"""PyTorch port, raw-audio training on the CPU against the JAX package: the
device front end (``ops/pipeline.py:waveform_to_features``) with dither off
and with dither fed JAX's own draws, the Python and native raw feeders'
crops, ``BatchFeeder``'s tuple assembly, one raw train step, the dithered
step's reproducibility, ``cli.train --raw`` with each feeder, and dithered
featurization (``data/features.py``).

Tolerances: features 1e-3 absolute in log-mel after CMN (both sides float32
matmuls over the same frames, as tests/test_torch_ops.py's FBANK parity);
crops and feeder batches bit-equal (the same RandomState calls in the same
order; the same C++ library); the train step at tests/test_torch_trainer.py's
tolerances (metrics 1e-4, gradient norm 2e-3, parameters 1e-3, momentum
5e-2 relative to each tensor's largest magnitude).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.data import native as jnative
from voxsrc2020_speaker_verification_tpu.data.raw_dataset import (
    RawAudioShardDataset as JaxRawDataset)
from voxsrc2020_speaker_verification_tpu.models import register_res2net_variant as jax_register
from voxsrc2020_speaker_verification_tpu.ops import fbank as jfb
from voxsrc2020_speaker_verification_tpu.ops import pipeline as jpipe
from voxsrc2020_speaker_verification_tpu.training import (
    TrainConfig as JaxConfig, create_train_state as jax_create, make_train_step as jax_step)
from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax, train_state_from_flax
from voxsrc2020_speaker_verification_tpu_torch.data import audio, native
from voxsrc2020_speaker_verification_tpu_torch.data import features as tfeatures
from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io
from voxsrc2020_speaker_verification_tpu_torch.data.dataset import BatchFeeder
from voxsrc2020_speaker_verification_tpu_torch.data.raw_dataset import RawAudioShardDataset
from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as tfb
from voxsrc2020_speaker_verification_tpu_torch.ops import pipeline as tpipe
from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
    dither_generator, make_train_step, schedule_values)
from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

torch.set_num_threads(1)

CFG = tfb.FbankConfig(num_bins=40, dither=0.0)
JCFG = jfb.FbankConfig(num_bins=40, dither=0.0)
L, CONTEXT, WINDOW = 20, 15, 30  # tests/test_raw_pipeline.py's small shapes
TOL_FEATS = 1e-3
TOL = 1e-4

THIN = "res2net50_thin_torch_raw"
THIN_KW = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
               width=(4, 8), split=4, output_dim=16)
jax_register(THIN, **THIN_KW)
register_res2net_variant(THIN, **THIN_KW)
STEP_CFG = dict(model=THIN, projection="sc_cm_linear", num_classes=16, dataset_length=160,
                feat_dim=16, feat_length=24, batch_size=8, num_accumulation_steps=2,
                bn_groups=2, bf16=False, raw_audio=True, cmn_window=WINDOW,
                cmn_context=CONTEXT)
START = 40  # constant LR, growing margin (tests/test_torch_trainer.py)

needs_native = pytest.mark.skipif(
    not native.available() or not jnative.available(),
    reason="the native library does not build here")


def utterance(seed, frames):
    rng = np.random.RandomState(seed)
    return (rng.randn((frames - 1) * CFG.frame_shift + CFG.frame_length) * 2000).astype(np.float32)


def crop_case(samples, t0):
    """The loader's context crop of frame t0 (tests/test_raw_pipeline.py)."""
    n = tfb.num_frames(len(samples), CFG)
    lo, hi = max(0, t0 - CONTEXT), min(n, t0 + L + CONTEXT)
    piece = samples[lo * CFG.frame_shift:min(len(samples),
                                              (hi - 1) * CFG.frame_shift + CFG.frame_length)]
    wave = np.zeros(tpipe.max_crop_samples(L, CONTEXT, CFG), np.int16)
    wave[:len(piece)] = tfb.pcm16(piece)
    return wave, len(piece), t0 - lo, 0


def short_case(frames, shift, seed=1):
    samples = utterance(seed, frames)
    wave = np.zeros(tpipe.max_crop_samples(L, CONTEXT, CFG), np.int16)
    wave[:len(samples)] = tfb.pcm16(samples)
    return wave, len(samples), 0, shift


def batch_of(cases):
    """(waves (B, S) int16, num_samples, target_offset, pad_shift) numpy."""
    return (np.stack([c[0] for c in cases]),
            *(np.asarray([c[k] for c in cases], np.int32) for k in (1, 2, 3)))


def port_features(batch, noise=None, cfg=CFG):
    return tpipe.waveform_to_features(
        *(torch.from_numpy(x) for x in batch), cfg, L, window=WINDOW, context=CONTEXT,
        noise=None if noise is None else torch.from_numpy(noise)).numpy()


def jax_features(batch, dither_key=None, cfg=JCFG):
    return np.asarray(jpipe.waveform_to_features(
        *(jnp.asarray(x) for x in batch), cfg, L, window=WINDOW, context=CONTEXT,
        dither_key=dither_key))


@pytest.fixture(scope="module")
def crops():
    """Crops of an 80-frame utterance at the start, inside and at the end
    (the CMN window clipped at either edge), and two short utterances
    zero-padded at shifts 0 and 5."""
    samples = utterance(0, 80)
    return batch_of([crop_case(samples, t0) for t0 in (0, 3, 30, 45, 60)]
                    + [short_case(12, 5), short_case(12, 0, seed=2)])


def test_crop_sizes_match_jax():
    for length, context in ((200, 150), (600, 150), (L, CONTEXT)):
        assert tpipe.crop_samples(length, CFG) == jpipe.crop_samples(length, JCFG)
        assert (tpipe.max_crop_samples(length, context, CFG)
                == jpipe.max_crop_samples(length, context, JCFG))
    n = torch.tensor([0, 399, 400, 559, 560, 80240])
    assert tpipe.num_frames_batch(n, CFG).tolist() == np.asarray(
        jfb.num_frames_batch(jnp.asarray(n.numpy()), JCFG)).tolist()


def test_waveform_to_features_matches_jax(crops):
    """Dither off: every crop position and the short-utterance zero pad
    within 1e-3 of the JAX pipeline; zero rows exactly where JAX has them."""
    got, want = port_features(crops), jax_features(crops)
    assert got.shape == want.shape == (len(crops[0]), L, CFG.num_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FEATS)
    np.testing.assert_array_equal((got == 0).all(-1), (want == 0).all(-1))  # padded rows
    # the plain pipeline is the same function
    ref = tpipe.waveform_to_features_reference(
        *(torch.from_numpy(x) for x in crops), CFG, L, window=WINDOW).numpy()
    np.testing.assert_array_equal(ref, got)


def test_dithered_features_match_jax_given_its_draws(crops):
    """Dither on: the port fed the draws JAX's fbank makes from its key
    (``normal(key, (B, T, frame_length))``) gives JAX's features within
    1e-3. The scale is 300 (int16 units) so that the draws move the
    features far beyond the tolerance (at Kaldi's 1.0 they move them
    ~4e-3 on these 2000-amplitude waves)."""
    cfg, jcfg = (tfb.FbankConfig(num_bins=40, dither=300.0),
                 jfb.FbankConfig(num_bins=40, dither=300.0))
    key = jax.random.PRNGKey(5)
    t = tfb.num_frames(crops[0].shape[1], cfg)
    noise = np.array(jax.random.normal(key, (crops[0].shape[0], t, cfg.frame_length),
                                       jnp.float32))
    got, want = port_features(crops, noise, cfg), jax_features(crops, key, jcfg)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FEATS)
    assert np.abs(got - port_features(crops)).max() > 100 * TOL_FEATS
    # without draws dither is off, as with dither_key=None
    np.testing.assert_array_equal(port_features(crops, None, cfg), port_features(crops))
    with pytest.raises(ValueError, match="dither"):
        tfb.fbank(torch.zeros(1, 1600), cfg)
    with pytest.raises(ValueError, match="noise"):
        tfb.fbank(torch.zeros(1, 1600), cfg, torch.zeros(1, 7, 400))  # 8 frames


def write_wav_scp(root, seed=0, num=10, spec_every=4):
    """A wav.scp of ``num`` utterances of 0.05-3 s (every third shorter
    than L frames), every ``spec_every``-th a JSON reverb + noise spec, and its
    utt2id over 4 speakers."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    rir = rng.randn(2400) * np.exp(-np.arange(2400) / 300.0)
    rir[30] = 4.0
    audio.write_wav(os.path.join(root, "rir.wav"), (rir * 6000).astype(np.float32))
    audio.write_wav(os.path.join(root, "noise.wav"), (rng.randn(8000) * 800).astype(np.float32))
    wav, utt2spk = {}, {}
    for i in range(num):
        utt = f"spk{i % 4}-u{i:02d}"
        path = os.path.join(root, f"{utt}.wav")
        seconds = rng.uniform(0.05, 0.2) if i % 3 == 0 else rng.uniform(0.2, 3.0)
        audio.write_wav(path, (rng.randn(int(seconds * 16000)) * 2000).astype(np.float32))
        wav[utt] = path
        if spec_every and i % spec_every == 1:
            wav[utt] = json.dumps({"source": path, "rir": os.path.join(root, "rir.wav"),
                                   "noises": [{"path": os.path.join(root, "noise.wav"),
                                               "snr": 10, "start": 0, "extend": True}]},
                                  separators=(",", ":"))
        utt2spk[utt] = f"spk{i % 4}"
    datadir.write_two_column(os.path.join(root, "wav.scp"), wav)
    utt2id = datadir.build_utt2id(utt2spk, sorted(set(utt2spk.values())))
    datadir.save_utt2id(os.path.join(root, "utt2id.pkl"), utt2id)
    return os.path.join(root, "wav.scp"), utt2id


def take(iterable, n):
    it = iter(iterable)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("training", [True, False], ids=["training", "eval"])
def test_raw_dataset_crops_equal_jax(tmp_path, training):
    """The same seed gives JAX's samples bit for bit: skips, crop positions,
    pad shifts, int16 waves (spec entries rendered by both packages' Python
    renderers) and labels, over two passes of the scp in training mode."""
    scp, utt2id = write_wav_scp(str(tmp_path))
    kw = dict(context=CONTEXT, training=training, seed=7, shard_index=1, num_shards=2)
    port = RawAudioShardDataset(scp, utt2id, L, cfg=CFG, **kw)
    ref = JaxRawDataset(scp, utt2id, L, cfg=JCFG, **kw)
    n = 8 if training else len(port.entries)
    got, want = take(port, n), take(ref, n)
    assert any(tfb.num_frames(int(s[0][1]), CFG) < L for s in got)  # a short one padded
    for (g, gl), (w, wl) in zip(got, want):
        assert gl == wl
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


@needs_native
def test_native_raw_feeder_equals_jax_class(tmp_path):
    """NativeRawBatchFeeder over the same library, scp and seed as the JAX
    package's class: the same batches (one worker thread: the batches are
    a function of the seed), the same dtypes and shapes, no decode errors."""
    scp, utt2id = write_wav_scp(str(tmp_path))
    kw = dict(cfg=None, context=CONTEXT, num_threads=1, seed=3, skip_percent=10)
    port = native.NativeRawBatchFeeder(scp, utt2id, L, 3, 2, **kw)
    ref = jnative.NativeRawBatchFeeder(scp, utt2id, L, 3, 2, **kw)
    try:
        for _ in range(3):
            (g, gl), (w, wl) = port.get(), ref.get()
            assert g[0].shape == (2, 3, tpipe.max_crop_samples(L, CONTEXT, tfb.FbankConfig()))
            assert [x.dtype for x in g] == [np.int16] + [np.int32] * 3
            for a, b in zip((*g, gl), (*w, wl)):
                np.testing.assert_array_equal(a, b)
        assert port.decode_errors() == 0 and port.dead_shards() == 0
    finally:
        port.close()
        ref.close()
    assert port.decode_errors() == 0


def test_batch_feeder_assembles_raw_tuples(tmp_path):
    """BatchFeeder over one raw source: ((A, B, S) int16 waves, and three
    (A, B) int32 fields), (A, B) labels, in the order the source yields."""
    scp, utt2id = write_wav_scp(str(tmp_path))
    kw = dict(cfg=CFG, context=CONTEXT, seed=11)
    feeder = BatchFeeder([RawAudioShardDataset(scp, utt2id, L, **kw)], batch_size=3,
                         num_accumulation_steps=2).start()
    try:
        batches = take(feeder, 2)
    finally:
        feeder.stop()
    samples = take(RawAudioShardDataset(scp, utt2id, L, **kw), 12)
    for k, (fields, labels) in enumerate(batches):
        assert isinstance(fields, tuple) and len(fields) == 4
        assert fields[0].shape == (2, 3, tpipe.max_crop_samples(L, CONTEXT, CFG))
        assert fields[0].dtype == np.int16 and labels.shape == (2, 3)
        want = samples[6 * k:6 * k + 6]
        for f in range(4):
            np.testing.assert_array_equal(fields[f].reshape(6, *fields[f].shape[2:]),
                                          np.stack([s[0][f] for s in want]))
        np.testing.assert_array_equal(labels.reshape(-1), [s[1] for s in want])


def raw_batch(config, seed):
    """One (A, B) raw batch: crops of 0.3-1 s utterances (both the crop and
    the short-utterance pad), as numpy."""
    rng = np.random.RandomState(seed)
    cfg = tfb.FbankConfig(num_bins=config.feat_dim)
    smax = tpipe.max_crop_samples(config.feat_length, config.cmn_context, cfg)
    a, b = config.num_accumulation_steps, config.batch_size
    waves = np.zeros((a, b, smax), np.int16)
    ns, off, shift = (np.zeros((a, b), np.int32) for _ in range(3))
    for i in range(a):
        for j in range(b):
            n = min(smax, int(rng.uniform(0.2, 1.0) * 16000))
            waves[i, j, :n] = tfb.pcm16(rng.randn(n) * 2000)
            frames = tfb.num_frames(n, cfg)
            ns[i, j] = n
            if frames >= config.feat_length:
                off[i, j] = rng.randint(0, frames - config.feat_length + 1)
            else:
                shift[i, j] = rng.randint(0, config.feat_length - frames + 1)
    labels = rng.randint(0, config.num_classes, (a, b)).astype(np.int32)
    return (waves, ns, off, shift), labels


@pytest.fixture(scope="module")
def jax_raw_step():
    """A JAX state at step START, and its state and metrics after one raw
    step (dither off)."""
    cfg = JaxConfig(**STEP_CFG, dither=0.0)
    state = jax_create(cfg, jax.random.PRNGKey(0))
    state = jax.device_get(state.replace(step=jnp.int32(START)))
    fields, labels = raw_batch(TrainConfig(**STEP_CFG), 0)
    after, metrics = jax.jit(jax_step(cfg))(state, tuple(jnp.asarray(x) for x in fields),
                                             jnp.asarray(labels), jax.random.PRNGKey(1))
    return state, jax.device_get(after), {k: float(v) for k, v in metrics.items()}


def port_state(js, config):
    return train_state_from_flax(int(js.step), js.params, js.batch_stats, js.momentum,
                                 config=config, device="cpu")


def assert_rel(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-4)
    assert err <= tol, f"{msg}: relative error {err} > {tol}"


def run_step(config, js, fields, labels, step=None):
    state = port_state(js, config)
    if step is not None:
        state.step = step
    return make_train_step(config)(state, tuple(torch.from_numpy(x) for x in fields),
                                   torch.from_numpy(labels).long())


def test_raw_train_step_matches_jax(jax_raw_step):
    """One raw step of the thin Res2Net (dither off) from JAX's state: the
    metrics, parameters, BN statistics and momentum of JAX's
    ``make_train_step`` with ``raw_audio=True`` at the trainer tests'
    tolerances (the front end's ~1e-5 log-mel difference stays inside
    them)."""
    js, want, metrics = jax_raw_step
    config = TrainConfig(**STEP_CFG, dither=0.0)
    lr, margin = schedule_values(config, START)
    assert lr > 0 and margin > 0
    state, m = run_step(config, js, *raw_batch(config, 0))
    assert state.step == START + 1 and set(m) == set(metrics)
    for k, v in metrics.items():
        assert_rel(float(m[k]), v, 20 * TOL if k == "gradient_norm" else TOL, k)
    for group, tree, got in (("params", want.params, state.params),
                             ("batch_stats", want.batch_stats, state.batch_stats),
                             ("momentum", want.momentum, state.momentum)):
        flat = from_flax({"params": tree} if group != "batch_stats" else {"batch_stats": tree},
                         projection=True)
        assert set(flat) == set(got), group
        for k, v in flat.items():
            assert_rel(got[k].detach().numpy(), v.numpy(),
                       {"momentum": 500 * TOL, "params": 10 * TOL}.get(group, TOL),
                       f"{group} {k}")


def test_dithered_step_is_reproducible_from_seed_and_step(jax_raw_step):
    """Dither on: the same (seed, step) draws the same noise, so two steps
    from one state agree bit for bit; dither off, another step or another
    seed gives another step."""
    js, _, _ = jax_raw_step
    config = TrainConfig(**STEP_CFG, dither=1.0)
    fields, labels = raw_batch(config, 0)
    (a, ma), (b, mb) = (run_step(config, js, fields, labels) for _ in range(2))
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    assert float(ma["loss"]) == float(mb["loss"])
    for other, step in ((TrainConfig(**STEP_CFG, dither=0.0), None), (config, START + 1),
                        (TrainConfig(**STEP_CFG, dither=1.0, seed=1), None)):
        _, m = run_step(other, js, fields, labels, step)
        assert float(m["loss"]) != float(ma["loss"]), (other.dither, other.seed, step)
    x = [torch.randn(4, generator=dither_generator(config, step, i, torch.device("cpu")))
         for step, i in ((START, 0), (START, 0), (START, 1), (START + 1, 0))]
    assert torch.equal(x[0], x[1])
    assert not any(torch.equal(x[0], y) for y in x[2:])


@pytest.mark.parametrize("feeder", ["native", "python"])
def test_train_cli_raw_on_cpu(tmp_path, capsys, feeder):
    """``cli.train --raw --device cpu``: two steps of the thin model from a
    wav.scp (plain wavs and JSON specs) through either feeder; the CLI says
    which ran and counts no decode errors. ``--cmvn-pkl`` with ``--raw``
    is refused."""
    if feeder == "native" and not native.available():
        pytest.skip("the native library does not build here")
    write_wav_scp(str(tmp_path / "data" / "tiny"), seed=1, num=12)
    argv = ["--recipe", "res2net_vox2_dev_aug", "--model", THIN, "--raw", "--device", "cpu",
            "--data-root", str(tmp_path / "data"), "--dataset", "tiny", "--num-classes", "4",
            "--dataset-length", "64", "--batch-size", "4", "--num-accumulation-steps", "2",
            "--bn-groups", "2", "--feat-length", "24", "--max-steps", "2", "--log-every", "1",
            "--no-checkpoint", "--num-workers", "2"]
    run = train_cli.main(argv + (["--no-native-feeder"] if feeder == "python" else []))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"feeder: {feeder} (raw, ")
    assert run.feeder == feeder and run.decode_errors == 0
    assert run.result.steps_run == 2 and out[-1].startswith("done: 2 steps")
    assert all(np.isfinite(h["loss"]) for h in run.result.history)
    with pytest.raises(SystemExit):
        train_cli.main(argv + ["--cmvn-pkl", str(tmp_path / "cmvn.pkl")])


def test_features_dither_seed(tmp_path):
    """``compute_features_for_dir(dither_seed=...)`` runs the dithered FBANK:
    one seed gives the same store twice, another seed another one, and the
    dither moves the features from the undithered store."""
    root = str(tmp_path / "d")
    write_wav_scp(root, seed=2, num=5, spec_every=0)
    stores = {}
    for name, seed in (("a", 3), ("b", 3), ("c", 4), ("off", None)):
        scp = tfeatures.compute_features_for_dir(root, 40, out_name=f"fbank_{name}",
                                                 compress=False, batch_size=2,
                                                 dither_seed=seed, device="cpu")
        stores[name] = dict(kaldi_io.read_mat_scp(scp))
    assert set(stores["a"]) == set(stores["off"]) and len(stores["a"]) == 5
    for utt, x in stores["a"].items():
        np.testing.assert_array_equal(x, stores["b"][utt])
        assert not np.array_equal(x, stores["c"][utt])
        assert x.shape == stores["off"][utt].shape
        assert 0 < np.abs(x - stores["off"][utt]).max() < 1.0
