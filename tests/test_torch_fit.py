"""PyTorch port, the feature-shard training path on the CPU: ``fit``'s
feeder health checks and SIGTERM preemption, the train CLI from a Kaldi
feature store (native and Python feeders, rematerialized, resumed), and the
sixteen-speaker learning gate of tests/test_e2e_learning.py on the port:
features from the port's FBANK, a CM-compressed store written by the port's
kaldi_io, NativeBatchFeeder -> fit -> extraction -> cosine and adaptive
s-norm, EER < 5% (the gate takes ~60 s on one CPU thread).

This file imports no JAX. Run as a script, it is the subprocess that the
preemption test signals: ``python tests/test_torch_fit.py <exp_dir>``.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.data import kaldi_io, native
from voxsrc2020_speaker_verification_tpu_torch.data.dataset import BatchFeeder, SyntheticDataset
from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
from voxsrc2020_speaker_verification_tpu_torch.training.checkpoint import CheckpointManager
from voxsrc2020_speaker_verification_tpu_torch.training.loop import fit
from voxsrc2020_speaker_verification_tpu_torch.utils import datadir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIN = "res2net50_thin_torch_fit"
register_res2net_variant(THIN, num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
                         width=(4, 8), split=4, output_dim=16)
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="the native library does not build here")


class SickFeeder:
    """Feeds fine but reports one dead shard, like a NativeBatchFeeder one
    of whose scp blocks decodes nothing."""

    def __iter__(self):
        rng = np.random.RandomState(0)
        while True:
            yield rng.randn(1, 2, 16, 8).astype(np.float32), np.zeros((1, 2), np.int32)

    def decode_errors(self):
        return 7

    def dead_shards(self):
        return 1


@pytest.mark.parametrize("log_every", [1, 0], ids=["logging", "no_logging"])
def test_fit_raises_on_a_dead_shard(log_every):
    """A dead feeder shard raises IOError at the next check, with logging on
    (every log_every steps) and off (every 100 steps)."""
    config = TrainConfig(model=THIN, projection="sc_cm_linear", num_classes=4,
                         dataset_length=1024, feat_dim=8, feat_length=16, batch_size=2,
                         num_accumulation_steps=1, bf16=False, exp_root="")
    with pytest.raises(IOError, match="decoded nothing over a full pass"):
        fit(config, SickFeeder(), log_every=log_every, max_steps=150, checkpoint=False,
            log_fn=lambda s: None, device="cpu")


PREEMPT_STEPS = 200  # epoch_size 40, 5 epochs


def preempt_child(exp_dir: str) -> None:
    """fit() on synthetic features with checkpoints; prints the log lines
    and a PREEMPTED/COMPLETED marker."""
    config = TrainConfig(model=THIN, projection="sc_cm_linear", num_classes=5,
                         dataset_length=160, feat_dim=8, feat_length=16, batch_size=4,
                         num_accumulation_steps=1, total_epochs=5, bf16=False, exp_root="")
    feeder = BatchFeeder([SyntheticDataset(8, 16, 5, seed=0)], 4, 1).start()
    try:
        result = fit(config, feeder, exp_dir=exp_dir, log_every=2,
                     log_fn=lambda s: print(s, flush=True), device="cpu")
    finally:
        feeder.stop()
    print(f"{'PREEMPTED' if result.preempted else 'COMPLETED'} step={result.state.step}",
          flush=True)


def run_child(exp_dir, term_after_step=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(exp_dir)], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines, sent = [], False
    deadline = time.monotonic() + timeout
    for line in proc.stdout:
        lines.append(line.rstrip())
        if term_after_step is not None and not sent and line.startswith(f"step {term_after_step}/"):
            proc.send_signal(signal.SIGTERM)
            sent = True
        if time.monotonic() > deadline:
            proc.kill()
            pytest.fail("the child process timed out:\n" + "\n".join(lines[-20:]))
    assert proc.wait(timeout=60) == 0, "\n".join(lines[-30:])
    return lines


def test_sigterm_checkpoints_and_resume(tmp_path):
    """SIGTERM mid-run: fit returns after the current step with a
    checkpoint at that step and preempted=True; a relaunch resumes from it
    and runs to the end."""
    exp = tmp_path / "exp"
    lines = run_child(exp, term_after_step=6)
    final = [ln for ln in lines if ln.startswith("PREEMPTED")]
    assert final, "\n".join(lines[-20:])
    step = int(final[0].split("step=")[1])
    assert 6 <= step < PREEMPT_STEPS
    assert any(ln.startswith(f"SIGTERM at step {step}") for ln in lines)
    assert CheckpointManager(str(exp)).latest_step() == step
    lines = run_child(exp)
    assert any(ln == f"COMPLETED step={PREEMPT_STEPS}" for ln in lines), "\n".join(lines[-20:])
    first = next(ln for ln in lines if ln.startswith("step "))
    assert int(first.split()[1].split("/")[0]) > step  # resumed, not restarted


def write_feature_store(root, dataset, utts, num_shards):
    """A data dir as the CLI reads it: CM-compressed arks with their scp,
    sharded into ``{N}-split/feats.{i}.scp``, and utt2id.pkl. ``utts``:
    {utterance: (speaker, (T, F) features)}."""
    data_dir = os.path.join(root, dataset)
    os.makedirs(data_dir, exist_ok=True)
    scp = os.path.join(data_dir, "feats.scp")
    with kaldi_io.ArkScpWriter(os.path.join(data_dir, "feats.ark"), scp, compress=True) as w:
        for utt, (_, feats) in utts.items():
            w.write(utt, feats)
    utt2spk = {utt: spk for utt, (spk, _) in utts.items()}
    datadir.write_two_column(os.path.join(data_dir, "utt2spk"), utt2spk)
    datadir.save_utt2id(os.path.join(data_dir, "utt2id.pkl"),
                        datadir.build_utt2id(utt2spk, sorted(set(utt2spk.values()))))
    datadir.shard_scp(scp, num_shards)
    return data_dir


@pytest.mark.parametrize("feeder", ["native", "python"])
def test_train_cli_from_a_feature_store(tmp_path, capsys, feeder):
    """The train CLI without --synthetic: two pretrain steps from a Kaldi
    feature store with stage 0 rematerialized and a checkpoint, then the
    LMFT recipe with stages 0-2 rematerialized, which resumes from that
    checkpoint (its first step is step 3)."""
    if feeder == "native" and not native.available():
        pytest.skip("the native library does not build here")
    rng = np.random.RandomState(4)
    utts = {f"spk{s}-u{i}": (f"spk{s}", rng.randn(int(rng.randint(20, 60)), 80).astype(np.float32))
            for s in range(4) for i in range(6)}
    for dataset in ("voxceleb2_dev_aug", "voxceleb2_dev"):  # pretrain, LMFT
        write_feature_store(str(tmp_path / "data"), dataset, utts, 2)
    common = ["--model", THIN, "--device", "cpu", "--data-root", str(tmp_path / "data"),
              "--exp-root", str(tmp_path / "exp"), "--num-shards", "2", "--num-workers", "2",
              "--batch-size", "4", "--num-accumulation-steps", "2", "--num-classes", "4",
              "--dataset-length", "80", "--log-every", "1", "--remat"]
    if feeder == "python":
        common.append("--no-native-feeder")
    run = train_cli.main(["--recipe", "res2net_vox2_dev_aug", *common, "--remat-stages", "0",
                          "--max-steps", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"feeder: {feeder} (2 shards")
    assert [ln.split()[1] for ln in out if ln.startswith("step ")] == ["1/2", "2/2"]
    assert run.feeder == feeder and run.decode_errors == 0 and run.result.steps_run == 2
    assert run.result.state.net.encoder.blocks[0][2] and not run.result.state.net.encoder.blocks[2][2]
    assert all(np.isfinite(h["loss"]) for h in run.result.history)
    pretrain_dir = next(r for r, _, fs in os.walk(tmp_path / "exp") if "config.json" in fs)
    assert CheckpointManager(pretrain_dir).latest_step() == 2
    run = train_cli.main(["--recipe", "res2net_finetune_vox2_dev", *common,
                          "--remat-stages", "0", "1", "2", "--feat-length", "24",
                          "--max-steps", "1"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in out if ln.startswith("step ")] == ["3/3"]
    assert run.result.state.step == 3
    assert all(block[2] for block in run.result.state.net.encoder.blocks)
    lmft_dir = next(r for r, _, fs in os.walk(tmp_path / "exp" / "voxceleb2_dev")
                    if "config.json" in fs)
    assert lmft_dir.endswith("frames24_scale32_margin0.4")
    assert CheckpointManager(lmft_dir).latest_step() == 3


def spk_features(rng, spk, n_spk, seconds=1.2, num_bins=24):
    """Speaker identity = two tones from a shared grid plus noise, through the
    port's plain FBANK (raw log-mel: the feeder applies the sliding CMN)."""
    from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as tfb

    t = np.arange(int(seconds * 16000)) / 16000
    grid = np.linspace(200, 6000, n_spk)
    sig = (3000 * np.sin(2 * np.pi * grid[spk] * t + rng.rand() * 6.28)
           + 2000 * np.sin(2 * np.pi * grid[(spk * 7 + 3) % n_spk] * t + rng.rand() * 6.28)
           + 700 * rng.randn(len(t)))
    wave = torch.from_numpy(np.clip(sig, -32768, 32767).astype(np.float32))
    return tfb.fbank(wave, tfb.FbankConfig(num_bins=num_bins, dither=0.0)).numpy()


@needs_native
def test_sixteen_speakers_fit_extract_asnorm(tmp_path):
    """The port's training path end to end on 16 synthetic speakers: the
    port's FBANK -> CM store by the port's kaldi_io -> NativeBatchFeeder ->
    fit (220 steps of the full schedule) -> bucketed masked extraction ->
    cosine and adaptive s-norm: EER < 5%, and asnorm no worse than cosine
    (within one flipped trial, 1/96 of the positives, plus margin: the
    feeder's two threads make the batches timing-dependent)."""
    from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np
    from voxsrc2020_speaker_verification_tpu_torch.eval.extract import extract_embeddings
    from voxsrc2020_speaker_verification_tpu_torch.eval.metrics import evaluate_trials
    from voxsrc2020_speaker_verification_tpu_torch.eval.scoring import (
        asnorm_scores, cosine_scores, l2norm, speaker_means)

    n_spk, feat_dim = 16, 24
    register_res2net_variant("res2net_port_test_tiny", num_filters=(8, 16, 16, 16),
                             block_sizes=(1, 1, 1, 1), width=(4, 8, 8, 8), split=2,
                             output_dim=32)
    config = TrainConfig(model="res2net_port_test_tiny", projection="sc_cm_linear",
                         num_classes=n_spk, num_centers=2, dataset_length=320,
                         feat_dim=feat_dim, feat_length=64, batch_size=32,
                         num_accumulation_steps=1, total_epochs=23, bf16=False, base_lr=0.05,
                         lr_boundaries_epochs=(1, 20, 23), margin_boundaries_epochs=(1, 5),
                         exp_root="", seed=0)
    rng = np.random.RandomState(7)
    scp = str(tmp_path / "feats.scp")
    utt2id = {}
    with kaldi_io.ArkScpWriter(str(tmp_path / "feats.ark"), scp, compress=True) as w:
        for spk in range(n_spk):
            for i in range(8):
                w.write(f"s{spk:02d}-u{i}", spk_features(rng, spk, n_spk))
                utt2id[f"s{spk:02d}-u{i}"] = spk
    feeder = native.NativeBatchFeeder(scp, utt2id, feat_dim, config.feat_length,
                                      config.batch_size, num_threads=2, seed=1)
    try:
        result = fit(config, feeder, max_steps=220, checkpoint=False, log_every=0,
                     log_fn=lambda s: None, device="cpu")
    finally:
        feeder.close()
    assert result.steps_run == 220
    encoder = result.state.net.encoder

    def embed(feats, mask):
        with torch.inference_mode():
            return encoder(torch.as_tensor(feats).float(), False, torch.as_tensor(mask).float())

    def extract(utts):
        return extract_embeddings(embed, iter(utts.items()), batch_size=8, buckets=(128,))

    test_utts = {f"s{spk:02d}-t{i}": sliding_cmn_np(spk_features(rng, spk, n_spk))
                 for spk in range(n_spk) for i in range(4)}
    cohort_utts = {f"s{spk:02d}-c{i}": sliding_cmn_np(spk_features(rng, spk, n_spk))
                   for spk in range(n_spk) for i in range(2)}
    xvec = {k: l2norm(v) for k, v in extract(test_utts).items()}
    utts = sorted(xvec)
    trials = [(int(a[:3] == b[:3]), a, b) for i, a in enumerate(utts) for b in utts[i + 1:]]
    scores = cosine_scores(xvec, trials)
    eer, _ = evaluate_trials(trials, scores)
    assert eer < 5.0, f"cosine EER {eer}% on 16 synthetic speakers"
    spk2utt = {}
    for u in cohort_utts:
        spk2utt.setdefault(u[:3], []).append(u)
    cohort = speaker_means(extract(cohort_utts), spk2utt)
    eer2, _ = evaluate_trials(trials, asnorm_scores(xvec, cohort, trials, scores,
                                                     topk=len(cohort), device="cpu"))
    assert eer2 < 5.0, f"asnorm EER {eer2}% (cosine {eer}%)"
    assert eer2 <= eer + 2.5, f"asnorm degraded a correct cosine score: {eer2}% vs {eer}%"


if __name__ == "__main__":
    preempt_child(sys.argv[1])
