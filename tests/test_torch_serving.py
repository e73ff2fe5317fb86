"""PyTorch port, serving layer: the port's EmbeddingService and TCP server
over an artifact converted from a JAX artifact, against the JAX package's
service over the original, on the CPU in float32.

Tolerances: port service vs JAX service 5e-4 abs per embedding; port served
vs port offline extraction 1e-5; wave vs feature requests 1e-4; cosine and
asnorm scores vs the JAX numpy path 1e-6.
"""

import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.eval import extract as jex
from voxsrc2020_speaker_verification_tpu.eval import metrics as jmetrics
from voxsrc2020_speaker_verification_tpu.eval import scoring as jscoring
from voxsrc2020_speaker_verification_tpu.eval.export import export_inference_artifact
from voxsrc2020_speaker_verification_tpu.eval.serving import EmbeddingService as JaxService
from voxsrc2020_speaker_verification_tpu.models import (
    register_res2net_variant as jax_register)
from voxsrc2020_speaker_verification_tpu.training import (
    TrainConfig as JaxConfig, create_train_state)
from voxsrc2020_speaker_verification_tpu_torch import resolve_device
from voxsrc2020_speaker_verification_tpu_torch.cli.serve import ServingClient, make_server
from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax
from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np
from voxsrc2020_speaker_verification_tpu_torch.eval import extract as tex
from voxsrc2020_speaker_verification_tpu_torch.eval import metrics as tmetrics
from voxsrc2020_speaker_verification_tpu_torch.eval import scoring as tscoring
from voxsrc2020_speaker_verification_tpu_torch.eval.export import (
    load_inference_artifact, save_inference_artifact)
from voxsrc2020_speaker_verification_tpu_torch.eval.serving import EmbeddingService
from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
from voxsrc2020_speaker_verification_tpu_torch.ops.fbank import (
    FbankConfig, fbank_reference, pcm16)

THIN = "res2net50_thin_torch_serve"
THIN_KW = dict(num_filters=(4, 8), block_sizes=(2, 1), block_strides=(1, 2),
               width=(4, 8), split=4, output_dim=16)
jax_register(THIN, **THIN_KW)
register_res2net_variant(THIN, **THIN_KW)
CFG = JaxConfig(
    model=THIN, projection="sc_cm_linear", num_classes=6, num_centers=2,
    dataset_length=48, feat_dim=40, feat_length=32,
    batch_size=4, num_accumulation_steps=1, bf16=False, exp_root="",
)
BATCH = 4


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(JAX artifact, port artifact) of the same randomized weights."""
    state = create_train_state(CFG, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) + rng.randn(*v.shape).astype(np.float32) * 0.3
                      if "mean" in str(p[-1])
                      else np.asarray(v) * rng.uniform(0.5, 2.0, v.shape).astype(np.float32)),
        jax.device_get(state.batch_stats))
    state = state.replace(batch_stats=stats)
    root = tmp_path_factory.mktemp("serve")
    jax_dir = export_inference_artifact(CFG, state, str(root / "jax"))
    params = jax.device_get(state.params)
    port_cfg = TrainConfig.from_json(f"{jax_dir}/config.json")
    port_dir = save_inference_artifact(
        port_cfg, from_flax({"params": params, "batch_stats": stats}),
        str(root / "port"), projection_params=params)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def service(artifacts):
    with EmbeddingService(artifacts[1], batch_size=BATCH, max_wait_ms=5.0,
                          device="cpu") as s:
        yield s


def _utts(seed=0):
    rng = np.random.RandomState(seed)
    # short (<25 frames), mid, bucket-boundary, and chunked (>1000 frames)
    return {
        f"u{i:02d}": rng.randn(t, CFG.feat_dim).astype(np.float32)
        for i, t in enumerate([12, 37, 256, 500, 999, 1000, 1337, 2503])
    }


def test_port_service_matches_jax_service(artifacts, service):
    feats = _utts()
    with JaxService(artifacts[0], batch_size=BATCH, max_wait_ms=5.0) as jax_svc:
        for utt, f in feats.items():
            want = jax_svc.embed_features(f, timeout=300)
            got = service.embed_features(f, timeout=300)
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-4, err_msg=utt)
        a, b = want, got
        np.testing.assert_allclose(service.score(a, b), jax_svc.score(a, b), rtol=0, atol=1e-6)
        np.testing.assert_allclose(service.score(a, b, asnorm=True, topk=5),
                                   jax_svc.score(a, b, asnorm=True, topk=5), rtol=0, atol=1e-6)


def test_served_embeddings_match_offline_extraction(artifacts, service):
    feats = _utts(1)
    _, embed = load_inference_artifact(artifacts[1], "cpu")
    fn = tex.make_bucketed_embed_fn(embed, batch_size=BATCH)
    want = tex.extract_embeddings(fn, feats.items(), batch_size=BATCH)
    for utt, f in feats.items():
        got = service.embed_features(f, cmvn=False, timeout=300)
        np.testing.assert_allclose(got, want[utt], atol=1e-5, rtol=1e-5, err_msg=utt)


def test_bf16_wire_service_matches_fp32(artifacts, service):
    feats = _utts(2)
    with EmbeddingService(artifacts[1], batch_size=BATCH, max_wait_ms=5.0,
                          wire="bfloat16", device="cpu") as bf:
        for utt, f in feats.items():
            got = bf.embed_features(f, cmvn=False, timeout=300)
            want = service.embed_features(f, cmvn=False, timeout=300)
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2, err_msg=utt)


def test_wave_requests_match_feature_requests(service):
    rng = np.random.RandomState(1)
    wave = pcm16(rng.randn(3 * 16000 + 321) * 2000).astype(np.float32)
    got = service.embed_wave(wave, timeout=300)
    feats = fbank_reference(torch.from_numpy(wave)[None],
                            FbankConfig(num_bins=CFG.feat_dim, dither=0.0))[0].numpy()
    want = service.embed_features(sliding_cmn_np(feats), cmvn=False, timeout=300)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_concurrent_requests_batch_and_match(artifacts, service):
    """2*BATCH same-bucket requests arriving together pack into 2 flushes and
    each resolves to its own embedding."""
    feats = {f"c{i}": np.random.RandomState(10 + i).randn(200, CFG.feat_dim)
             .astype(np.float32) for i in range(2 * BATCH)}
    with EmbeddingService(artifacts[1], batch_size=BATCH, max_wait_ms=2000.0,
                          device="cpu") as svc:
        before = svc.num_flushes
        reqs = {u: svc.submit_features(f, cmvn=False) for u, f in feats.items()}
        got = {u: r.result(timeout=300) for u, r in reqs.items()}
        assert svc.num_flushes - before == 2
    serial = {u: service.embed_features(f, cmvn=False, timeout=300) for u, f in feats.items()}
    for u in feats:
        np.testing.assert_allclose(got[u], serial[u], atol=1e-5, err_msg=u)


def test_rejects_inputs_beyond_caps_and_bad_topk(service):
    from voxsrc2020_speaker_verification_tpu_torch.eval import serving as S

    with pytest.raises(ValueError, match="features must be"):
        service.embed_features(np.zeros((50, CFG.feat_dim + 3), np.float32))
    with pytest.raises(ValueError, match="exceeds the serving cap"):
        service.embed_features(np.zeros((S._CMVN_BUCKETS[-1] + 1, CFG.feat_dim), np.float32))
    with pytest.raises(ValueError, match="exceeds the serving cap"):
        service.embed_wave(np.zeros(16000 * (S._WAVE_BUCKET_SECONDS[-1] + 1), np.float32))
    a, b = np.random.RandomState(5).randn(2, 16)
    with pytest.raises(ValueError, match="topk >= 2"):
        service.score(a, b, asnorm=True, topk=1)


@pytest.fixture(scope="module")
def server(artifacts):
    srv = make_server(artifacts[1], host="127.0.0.1", port=0, batch_size=BATCH,
                      max_wait_ms=5.0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.service.close()
    srv.server_close()


def test_tcp_roundtrip(server):
    host, port = server.server_address[:2]
    rng = np.random.RandomState(3)
    with ServingClient(host, port) as c:
        info = c.ping()
        assert info["model"] == THIN and info["feat_dim"] == CFG.feat_dim
        feats = rng.randn(300, CFG.feat_dim).astype(np.float32)
        via_tcp = c.embed_features(feats, cmvn=False)
        direct = server.service.embed_features(feats, cmvn=False, timeout=300)
        np.testing.assert_allclose(via_tcp, direct, atol=1e-6)
        emb_w = c.embed_wave(rng.randn(16000) * 2000)
        assert emb_w.shape == direct.shape and np.isfinite(emb_w).all()
        assert c.score(via_tcp, emb_w) == pytest.approx(
            server.service.score(via_tcp, emb_w), abs=1e-6)
        assert np.isfinite(c.score(via_tcp, emb_w, asnorm=True, topk=5))
        with pytest.raises(RuntimeError, match="unknown op"):
            c._call({"op": "nonsense"})
        assert c.ping()["ok"]  # the connection survives an error


def test_cosine_and_asnorm_scores_match_jax_numpy_path():
    rng = np.random.RandomState(6)
    xv = {f"u{i}": tscoring.l2norm(rng.randn(16)) for i in range(20)}
    spk2utt = {f"s{i}": [f"u{j}" for j in range(i, 20, 7)] for i in range(7)}
    cohort = {f"c{i}": rng.randn(16).astype(np.float32) for i in range(30)}
    trials = [(int(rng.randint(2)), f"u{rng.randint(20)}", f"u{rng.randint(20)}")
              for _ in range(50)]
    raw = tscoring.cosine_scores(xv, trials)
    np.testing.assert_array_equal(raw, jscoring.cosine_scores(xv, trials))
    means_p, means_j = tscoring.speaker_means(xv, spk2utt), jscoring.speaker_means(xv, spk2utt)
    for k in means_j:
        np.testing.assert_array_equal(means_p[k], means_j[k])
    got = tscoring.asnorm_scores(xv, cohort, trials, raw, topk=10, device="cpu")
    mat, i1, i2 = jscoring._trial_index(xv, trials)
    m, s = jscoring.cohort_stats(mat, np.stack(list(cohort.values())), topk=10, use_device=False)
    want = 0.5 * ((raw - m[i1]) / s[i1] + (raw - m[i2]) / s[i2])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_evaluate_trials_matches_jax():
    rng = np.random.RandomState(7)
    labels = rng.randint(2, size=400)
    scores = np.round(rng.randn(400) + labels, 1)  # rounded: ties included
    trials = [(int(l), "a", "b") for l in labels]
    assert tmetrics.evaluate_trials(trials, scores) == pytest.approx(
        jmetrics.evaluate_trials(trials, scores), abs=1e-12)
    assert tmetrics.compute_eer_and_min_dcf(labels, scores) == pytest.approx(
        jmetrics.compute_eer_and_min_dcf(labels, scores), abs=1e-12)


def test_extract_helpers_match_jax():
    for t in (0, 12, 24, 25, 999, 1000, 1024, 1025, 2503, 3000):
        assert tex.chunk_spans(t) == jex.chunk_spans(t)
    for n in (1, 255, 256, 257, 999, 1000, 5000):
        assert tex.select_bucket([256, 512, 1000], n) == jex.select_bucket([256, 512, 1000], n)
    for name in ("res2net50_w24_s4_c32", "res2net50_w8_s6_c16", "res2net101_w24_s4_c32_att"):
        assert tex.default_batch_size(name) == jex.default_batch_size(name)
    rng = np.random.RandomState(8)
    chunks = [(5, rng.randn(5, 3).astype(np.float32) * 100), (2, rng.randn(2, 3).astype(np.float32))]
    for port_wire, jax_wire in ((None, None), (torch.bfloat16, ml_dtypes.bfloat16)):
        f, m = tex.pack_chunk_batch(chunks, 8, 3, port_wire)
        jf, jm = jex.pack_chunk_batch(chunks, 8, 3, jax_wire)
        np.testing.assert_array_equal(f.float().numpy(), jf.astype(np.float32))
        np.testing.assert_array_equal(m.numpy(), jm)


def test_config_reads_jax_config_json(artifacts):
    cfg = TrainConfig.from_json(f"{artifacts[0]}/config.json")
    assert cfg.model == THIN and cfg.feat_dim == CFG.feat_dim and cfg.bf16 is False
    assert cfg.learning_rate == CFG.learning_rate
    assert cfg.exp_name == CFG.exp_name and cfg.total_steps == CFG.total_steps


def test_default_device_is_the_gpu():
    """device=None means cuda; without a GPU that raises, never falls back."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
