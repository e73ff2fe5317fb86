"""PyTorch port, sliding CMVN (``ops/cmvn.py``): the plain version, which
every CPU tensor takes, against the JAX package's ``ops/cmvn.py`` and
against float64 references, on the same numpy inputs.

Tolerances: against JAX 5e-5 absolute on features of 12 +- 3. The JAX
version sums in a float32 cumulative sum that drifts with T (measured
~1.5e-4 at 16000 frames, and ~7e-5 at 2000 frames with norm_vars), so
norm_vars is held against JAX up to 1000 frames, and everything longer
against float64: the host's ``sliding_cmn_np`` at 16000 frames and a
frame-by-frame float64 loop with norm_vars at 2000, 2e-6 (a few float32
ulps at these magnitudes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu.ops import cmvn as jcmvn
from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np
from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn as tcmvn

from test_torch_kernels import cmvn_loop_float64

torch.set_num_threads(1)


def feats(seed, b, t, f=80):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, f) * 3 + 12).astype(np.float32)


# (T, center, norm_vars, min_window): batched and padded (one full row, one
# row shorter than the window, one between)
@pytest.mark.parametrize("t,center,norm_vars,min_window", [
    pytest.param(2000, True, False, 100, id="2000-centred"),
    pytest.param(2000, False, False, 100, id="2000-trailing"),
    pytest.param(1000, True, True, 100, id="1000-centred-norm_vars"),
    pytest.param(1000, False, True, 100, id="1000-trailing-norm_vars"),
    pytest.param(500, False, False, 350, id="500-trailing-min_window"),
    pytest.param(301, True, False, 100, id="301-centred"),
])
def test_sliding_cmvn_matches_jax(t, center, norm_vars, min_window):
    x = feats(t, 3, t)
    n = np.array([t, t * 2 // 3, 250], np.int32)
    kw = dict(center=center, norm_vars=norm_vars, min_window=min_window)
    want = np.asarray(jcmvn.sliding_cmvn(jnp.asarray(x), jnp.asarray(n), **kw))
    got = tcmvn.sliding_cmvn(torch.from_numpy(x), torch.from_numpy(n), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # every frame, the padded ones included (normalized with the last window)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # no num_valid: every frame valid
    want = np.asarray(jcmvn.sliding_cmvn(jnp.asarray(x), **kw))
    np.testing.assert_allclose(tcmvn.sliding_cmvn(torch.from_numpy(x), **kw).numpy(),
                               want, rtol=0, atol=5e-5)


def test_sliding_cmvn_one_utterance_and_window_matches_jax():
    """(T, F) input with and without a count, and a window other than 300."""
    x = feats(7, 1, 640, 40)[0]
    for n, kw in ((None, dict(window=101)), (500, dict()), (640, dict(center=False, window=64))):
        want = np.asarray(jcmvn.sliding_cmvn(jnp.asarray(x), n if n is None else jnp.asarray(n), **kw))
        got = tcmvn.sliding_cmvn(torch.from_numpy(x), n, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_sliding_cmvn_long_utterance_matches_float64():
    """At 16000 frames the plain version equals the host's float64 CMN, where
    the JAX version's float32 cumulative sum has drifted."""
    x = feats(3, 1, 16000)
    got = tcmvn.sliding_cmvn(torch.from_numpy(x)).numpy()[0]
    np.testing.assert_allclose(got, sliding_cmn_np(x[0]), rtol=0, atol=2e-6)


@pytest.mark.parametrize("center", [True, False], ids=["centred", "trailing"])
def test_sliding_cmvn_norm_vars_matches_float64_loop(center):
    """norm_vars at 2000 frames, padded, against a frame-by-frame float64 loop."""
    x = feats(11, 2, 2000)
    n = np.array([2000, 1234], np.int32)
    got = tcmvn.sliding_cmvn(torch.from_numpy(x), torch.from_numpy(n), center=center,
                             norm_vars=True).numpy()
    for i in range(2):
        want = cmvn_loop_float64(x[i], n[i], 300, center, True, 100)
        np.testing.assert_allclose(got[i], want, rtol=0, atol=2e-6)


def test_global_cmvn_matches_jax():
    x = feats(5, 2, 30, 8)
    mean, std = x.mean(axis=(0, 1)), x.std(axis=(0, 1))
    want = np.asarray(jcmvn.global_cmvn(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std)))
    got = tcmvn.global_cmvn(torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(std))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sliding_cmvn_refuses_bad_arguments():
    x = torch.zeros(2, 10, 4)
    with pytest.raises(ValueError):
        tcmvn.sliding_cmvn(x, window=0)
    with pytest.raises(ValueError):
        tcmvn.sliding_cmvn(x, torch.tensor([10, 9, 8]))
    with pytest.raises(ValueError):
        tcmvn.sliding_cmvn(torch.zeros(10))


@pytest.mark.parametrize("center", [True, False], ids=["centred", "trailing"])
def test_window_at_is_window_bounds_frame_by_frame(center):
    """K7's scalar window rule (``window_at``, as csrc/sliding_cmvn.cu
    computes it) is the plain version's ``window_bounds`` at every frame."""
    t, ns = 700, [0, 1, 99, 150, 299, 300, 301, 450, 699, 700]
    for mw in (100, 450):
        start, end = tcmvn.window_bounds(t, torch.tensor(ns), 300, center, mw)
        for i, n in enumerate(ns):
            got = [tcmvn.window_at(f, n, 300, center, mw) for f in range(t)]
            assert got == list(zip(start[i].tolist(), end[i].tolist())), (n, mw)


def test_cmvn_launch_mix_is_the_streams_launches(monkeypatch):
    """``cli.extract.cmvn_launch_mix`` gives the (rows, T) of every
    sliding_cmvn call that ``cmvn_full_stream`` makes: bucket batches of 8
    (tails padded) and an utterance beyond the largest bucket alone."""
    from collections import Counter

    from voxsrc2020_speaker_verification_tpu_torch.cli import extract

    calls = Counter()
    plain = tcmvn.sliding_cmvn

    def record(feats_, num_valid=None, **kw):
        calls[tuple(feats_.shape[:2])] += 1
        return plain(feats_, num_valid, **kw)

    monkeypatch.setattr(tcmvn, "sliding_cmvn", record)
    rng = np.random.RandomState(5)
    lengths = list(rng.randint(20, 400, 30)) + [401, 900, 950]
    buckets = (100, 200, 400)
    stream = ((str(i), np.zeros((n, 4), np.float32)) for i, n in enumerate(lengths))
    out = list(extract.cmvn_full_stream(stream, window=9, bucket_frames=buckets, device="cpu"))
    assert [u for u, _ in out] != [] and sorted(int(u) for u, _ in out) == list(range(len(lengths)))
    assert extract.cmvn_launch_mix(lengths, bucket_frames=buckets) == dict(calls)
