"""PyTorch port, reference TF checkpoint import: the TF1 name map and
``import_reference_weights`` against the JAX package's, and the port's
tensor-bundle reader (``utils/tf_bundle.py``, no TensorFlow) against
``tf.train.load_checkpoint``.

TensorFlow runs in a subprocess (tests/tf_bundle_oracle.py, one per module,
with a timeout), as tests/ref_oracle.py does; those tests skip where
``tensorflow`` is missing, as tests/test_tf_import.py does.

Tolerances: name maps equal (names, collections, paths); imported weights
bit for bit; the thin forward of imported weights 1e-4 against JAX's; the
reader's values bit for bit against TF's (bfloat16 widened to float32 on
both sides).
"""

import importlib.util
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxsrc2020_speaker_verification_tpu.models as jax_models
from voxsrc2020_speaker_verification_tpu.utils import tf_import as jax_tf_import
from voxsrc2020_speaker_verification_tpu_torch import models
from voxsrc2020_speaker_verification_tpu_torch.convert import from_flax
from voxsrc2020_speaker_verification_tpu_torch.speaker_net import SpeakerNet
from voxsrc2020_speaker_verification_tpu_torch.utils import tf_bundle, tf_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import tf_bundle_writer  # noqa: E402

torch.set_num_threads(1)

ORACLE = os.path.join(os.path.dirname(__file__), "tf_bundle_oracle.py")
TOL = dict(rtol=1e-4, atol=1e-4)

# the model ids of the JAX package as it ships (thin variants other test
# modules register are not in this tuple)
REFERENCE_MODELS = tuple(m for m in jax_models.MODEL_NAMES
                         if m == "tdnn" or m in jax_models.RES2NET_CONFIGS
                         or m in jax_models.DPN_CONFIGS)
ECAPA_MODELS = tuple(m for m in jax_models.MODEL_NAMES if m.startswith("ecapa"))

THIN = {
    "res2net_thin_tfimport": dict(num_filters=(4, 8), block_sizes=(2, 1),
                                  block_strides=(1, 2), width=(4, 8), split=4, output_dim=8),
    "res2net_att_thin_tfimport": dict(num_filters=(4, 8), block_sizes=(1, 2),
                                      block_strides=(1, 2), width=(4, 8), split=3,
                                      output_dim=8, pool="att_stats"),
}
for _name, _kw in THIN.items():
    jax_models.register_res2net_variant(_name, **_kw)
    models.register_res2net_variant(_name, **_kw)
THIN_TDNN = dict(block_filters=(16, 16, 16, 16, 32), output_dim=8)
jax_models.register_tdnn_variant("tdnn_thin_tfimport", **THIN_TDNN)
models.register_tdnn_variant("tdnn_thin_tfimport", **THIN_TDNN)
_jax_dpn = sys.modules["voxsrc2020_speaker_verification_tpu.models.dpn"]
THIN_DPN = dict(output_dim=8, bw=8, k_r=8, cardinality=4, k_sec=(2, 1, 2, 1),
                inc_sec=(4, 4, 4, 8))
_jax_dpn.DPN_CONFIGS["dpn_thin_tfimport"] = _jax_dpn.DpnConfig(name="dpn_thin_tfimport",
                                                              **THIN_DPN)
models.DPN_CONFIGS["dpn_thin_tfimport"] = models.DpnConfig(name="dpn_thin_tfimport",
                                                           **THIN_DPN)
# (model, feat_dim)
THIN_MODELS = [("res2net_thin_tfimport", 16), ("res2net_att_thin_tfimport", 16),
               ("tdnn_thin_tfimport", 12), ("dpn_thin_tfimport", 16)]


# ---------------------------------------------------------------------------
# name map and import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", REFERENCE_MODELS)
def test_var_map_equals_jax(model):
    assert tf_import.reference_var_map(model) == jax_tf_import.reference_var_map(model)


def test_var_maps_refuse_what_jax_refuses():
    for model in ECAPA_MODELS + ("no_such_model",):
        with pytest.raises(ValueError):
            jax_tf_import.reference_var_map(model)
        with pytest.raises(ValueError):
            tf_import.reference_var_map(model)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def jax_snapshot(model, feat_dim, seed=0):
    """A reference snapshot ({tf name: array}) of randomized JAX variables
    of ``model`` (BN statistics moved off identity), and those variables."""
    net = jax_models.get_model(model)
    variables = jax.device_get(net.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 50, feat_dim)), False))
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) * rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        + rng.randn(*v.shape).astype(np.float32) * 0.1, variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    snap = {}
    for tf_name, (col, path) in jax_tf_import.reference_var_map(model).items():
        snap[tf_name + ":0"] = _leaf(variables[col], path)
        if col == "params":
            snap[tf_name + "/Momentum"] = _leaf(variables[col], path) * 0.5
    snap["global_step:0"] = np.asarray(17, np.int64)
    return snap, variables


@pytest.mark.parametrize("model,feat_dim", THIN_MODELS)
def test_import_matches_jax(model, feat_dim):
    """The port's import of a snapshot, through from_flax, is the state_dict
    of JAX's import of it; the thin forwards agree at 1e-4."""
    snap, variables = jax_snapshot(model, feat_dim)
    params, stats = tf_import.import_reference_weights(snap, model)
    jparams, jstats = jax_tf_import.import_reference_weights(snap, model)
    got = from_flax({"params": {"encoder": params}, "batch_stats": {"encoder": stats}})
    want = from_flax({"params": {"encoder": jparams}, "batch_stats": {"encoder": jstats}})
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    net = SpeakerNet(model, feat_dim)
    net.load_state_dict(got)
    net.eval()
    x = np.random.RandomState(1).randn(3, 40, feat_dim).astype(np.float32)
    with torch.inference_mode():
        ours = net.embed(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax_models.get_model(model).apply(variables, jnp.asarray(x), False))
    np.testing.assert_allclose(ours, theirs, **TOL)
    # momentum slots import as params only
    mom, _ = tf_import.import_reference_weights(
        {k[:-len("/Momentum")]: v for k, v in snap.items() if k.endswith("/Momentum")},
        model, params_only=True)
    jmom, _ = jax_tf_import.import_reference_weights(
        {k[:-len("/Momentum")]: v for k, v in snap.items() if k.endswith("/Momentum")},
        model, params_only=True)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, mom, jmom))


def test_import_with_projection_and_missing_variables():
    snap, _ = jax_snapshot("res2net_thin_tfimport", 16)
    snap["sc_cm_linear/kernel"] = np.ones((2, 8, 5), np.float32)
    params, _ = tf_import.import_reference_weights(snap, "res2net_thin_tfimport",
                                                   projection_id="sc_cm_linear")
    jparams, _ = jax_tf_import.import_reference_weights(snap, "res2net_thin_tfimport",
                                                        projection_id="sc_cm_linear")
    assert sorted(params) == sorted(jparams) == ["encoder", "projection"]
    np.testing.assert_array_equal(params["projection"]["kernel"], jparams["projection"]["kernel"])
    kernel = snap.pop("conv2d/kernel:0")
    with pytest.raises(KeyError, match="missing 1 variables"):
        tf_import.import_reference_weights(snap, "res2net_thin_tfimport")
    snap["conv2d/kernel:0"] = kernel
    with pytest.raises(KeyError, match="projection kernel"):
        tf_import.import_reference_weights(snap, "res2net_thin_tfimport",
                                           projection_id="am_softmax", params_only=True)


def test_reference_snapshot_inverts_the_map():
    """scripts/tf_bundle_writer.py:reference_snapshot (the port's weights as
    reference variables) followed by the import gives the weights back."""
    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
    from voxsrc2020_speaker_verification_tpu_torch.convert import init_weights
    from voxsrc2020_speaker_verification_tpu_torch.training.speaker_net import (
        SpeakerNet as TrainNet)

    cfg = TrainConfig(model="res2net_att_thin_tfimport", num_classes=5, feat_dim=16)
    sd = init_weights(cfg, torch.Generator().manual_seed(3), projection=True)
    assert TrainNet(cfg.model, cfg.projection, 5, 2, 16).state_dict().keys() == sd.keys()
    snap = tf_bundle_writer.reference_snapshot(sd, cfg.model, momentum=sd, step=9)
    params, stats = tf_import.import_reference_weights(snap, cfg.model,
                                                       projection_id="sc_cm_linear")
    back = from_flax({"params": params, "batch_stats": stats}, projection=True)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    assert int(snap["global_step"]) == 9


# ---------------------------------------------------------------------------
# CRC32C and the bundle reader
# ---------------------------------------------------------------------------

def _slow_crc32c(data: bytes) -> int:
    reg = 0xFFFFFFFF
    for b in data:
        reg ^= b
        for _ in range(8):
            reg = (reg >> 1) ^ (0x82F63B78 if reg & 1 else 0)
    return reg ^ 0xFFFFFFFF


@pytest.mark.parametrize("data,want", [
    (b"", 0), (b"a", 0xC1D04330), (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E), (bytes(range(31, -1, -1)), 0x113FDB5C)])
def test_crc32c_known_vectors(data, want):
    """The standard vectors (RFC 3720 B.4 and "123456789")."""
    assert tf_bundle.crc32c(data) == want


@pytest.mark.parametrize("n", [1, 3, 4, 5, 255, 1024, 4097, 65536 + 13])
def test_crc32c_chunking(n):
    """Every chunk count gives the bitwise CRC."""
    data = np.random.RandomState(n).bytes(n)
    want = _slow_crc32c(data)
    for chunks in (None, 1, 2, 3, 64, 1 << 16):
        assert tf_bundle.crc32c(data, chunks) == want, chunks


def writer_tensors():
    rng = np.random.RandomState(5)
    t = {"enc/conv2d/kernel": rng.randn(3, 3, 4, 8).astype(np.float32),
         "enc/f64": rng.randn(5), "enc/i32": rng.randint(-9, 9, 7).astype(np.int32),
         "global_step": np.asarray(4321, np.int64), "flags": rng.rand(6) > 0.5,
         "h/f16": rng.randn(3, 2).astype(np.float16), "h/bf16": rng.randn(4).astype(np.float32),
         "s": np.array([b"ab", b"", "é".encode()], object), "e": np.zeros((2, 0), np.float32),
         "sc": np.float32(-1.25)}
    for i in range(60):  # several data blocks, restart points past 16 entries
        t[f"layer{i // 10}/conv2d_{i}/kernel/Momentum"] = rng.randn(4, 3).astype(np.float32)
    return t


@pytest.fixture(scope="module")
def tf_oracle(tmp_path_factory):
    """Bundles TF writes, bundles the writer writes, and what TF reads from
    each (one TF subprocess for the module)."""
    if importlib.util.find_spec("tensorflow") is None:  # found, not imported here
        pytest.skip("tensorflow is not installed")
    out = tmp_path_factory.mktemp("tf_bundles")
    tensors = writer_tensors()
    prefixes = []
    for shards in (1, 3):
        p = str(out / f"writer{shards}" / "model.ckpt-4321")
        tf_bundle_writer.write_bundle(p, tensors, num_shards=shards, bfloat16=["h/bf16"],
                                      block_size=512)
        prefixes.append(p)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TF_CPP_MIN_LOG_LEVEL="3")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, ORACLE, str(out), *prefixes], capture_output=True,
                         text=True, env=env, timeout=600)
    if res.returncode != 0:
        pytest.fail(f"TF oracle failed (rc={res.returncode}): {res.stderr[-2000:]}")
    with open(out / "read.pkl", "rb") as f:
        read = pickle.load(f)
    return out, tensors, prefixes, read


def assert_same(got: np.ndarray, want: np.ndarray, name: str):
    assert got.shape == want.shape, name
    if want.dtype == object:
        assert [bytes(x) for x in got.reshape(-1)] == [bytes(x) for x in want.reshape(-1)], name
    else:
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("bundle", ["one/ckpt", "two/merged"])
def test_reader_matches_tf_on_tf_bundles(tf_oracle, bundle):
    """Every dtype the reader takes, a scalar, an empty tensor, a string
    tensor, and a two-shard bundle from MergeV2Checkpoints."""
    out, _, _, read = tf_oracle
    prefix = str(out / bundle)
    want = read[prefix]
    reader = tf_bundle.BundleReader(prefix)
    assert reader.num_shards == (2 if bundle.startswith("two") else 1)
    got = reader.read_all()
    assert sorted(got) == sorted(want) and len(want) == 11
    for name in want:
        assert_same(got[name], want[name], name)
    assert tf_import.load_tf_checkpoint(prefix).keys() == want.keys()


def test_reader_refuses_what_it_does_not_read(tf_oracle):
    out = tf_oracle[0]
    reader = tf_bundle.BundleReader(str(out / "uint8" / "ckpt"))
    np.testing.assert_array_equal(reader.get_tensor("w"), np.arange(5, dtype=np.float32))
    with pytest.raises(tf_bundle.BundleError, match="odd/uint8: dtype 4"):
        reader.get_tensor("odd/uint8")
    with pytest.raises(tf_bundle.BundleError, match="part: a partitioned"):
        tf_bundle.load_bundle(str(out / "sliced" / "ckpt"))


def test_flipped_data_byte_raises(tf_oracle, tmp_path):
    out = tf_oracle[0]
    src = out / "one"
    for f in os.listdir(src):
        (tmp_path / f).write_bytes((src / f).read_bytes())
    reader = tf_bundle.BundleReader(str(tmp_path / "ckpt"))
    entry = reader.entries["big/Momentum"]
    data = tmp_path / "ckpt.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[entry["offset"] + entry["size"] // 2] ^= 0x10
    data.write_bytes(bytes(raw))
    reader = tf_bundle.BundleReader(str(tmp_path / "ckpt"))
    with pytest.raises(tf_bundle.BundleError, match="big/Momentum: data CRC32C mismatch"):
        reader.get_tensor("big/Momentum")
    # the other variables still read
    np.testing.assert_array_equal(reader.get_tensor("meta/scalar"), np.float32(2.5))


def test_compressed_index_block_raises(tf_oracle, tmp_path):
    """A block whose type byte is not 0 (compressed) is refused, by name."""
    prefix = tf_oracle[2][0]
    for ext in (".index", ".data-00000-of-00001"):
        (tmp_path / ("m" + ext)).write_bytes(open(prefix + ext, "rb").read())
    raw = bytearray((tmp_path / "m.index").read_bytes())
    first = tf_bundle.read_varint(raw[-48:], tf_bundle.read_varint(raw[-48:], 0)[1])[1]
    index_offset, p = tf_bundle.read_varint(raw[-48:], first)
    index_size, _ = tf_bundle.read_varint(raw[-48:], p)
    raw[index_offset + index_size] = 1
    (tmp_path / "m.index").write_bytes(bytes(raw))
    with pytest.raises(tf_bundle.BundleError, match="compression type 1"):
        tf_bundle.BundleReader(str(tmp_path / "m"))


@pytest.mark.parametrize("shards", [1, 3])
def test_writer_bundles_read_by_tf(tf_oracle, shards):
    """scripts/tf_bundle_writer.py's bundles, as TF reads them and as the
    port reads them."""
    _, tensors, prefixes, read = tf_oracle
    prefix = prefixes[[1, 3].index(shards)]
    want = read[prefix]
    assert sorted(want) == sorted(tensors)
    got = tf_bundle.load_bundle(prefix)
    for name, value in tensors.items():
        if name == "h/bf16":
            bits = value.view(np.uint32)
            value = (((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16).view(np.float32)
        assert_same(want[name], np.asarray(value), name)
        assert_same(got[name], want[name], name)
