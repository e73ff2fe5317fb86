"""TensorFlow side of tests/test_torch_tf_import.py, run in a subprocess:

    python tests/tf_bundle_oracle.py OUT_DIR [PREFIX ...]

writes checkpoints with ``tf.raw_ops.SaveV2`` under OUT_DIR (``one/ckpt``:
every dtype the port's reader takes, a scalar and an empty tensor;
``two/merged``: the same split over two shards by ``MergeV2Checkpoints``;
``uint8/ckpt``: a dtype the reader refuses; ``sliced/ckpt``: a partitioned
variable), then pickles to OUT_DIR/read.pkl what ``tf.train.load_checkpoint``
reads from each of those and from every PREFIX given (bundles written by
scripts/tf_bundle_writer.py): ``{prefix: {name: value}}``, bfloat16 widened
to float32, strings as object arrays of bytes.
"""

import os
import pickle
import sys

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import numpy as np  # noqa: E402
import tensorflow as tf  # noqa: E402


def values():
    rng = np.random.RandomState(0)
    return {
        "enc/conv2d/kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
        "enc/f64": rng.randn(7),
        "enc/i32": rng.randint(-1000, 1000, (2, 3)).astype(np.int32),
        "global_step": np.asarray(123456789012, np.int64),
        "flags/bool": rng.rand(9) > 0.5,
        "half/f16": rng.randn(4, 4).astype(np.float16),
        "half/bf16": tf.constant(rng.randn(6, 2).astype(np.float32), dtype=tf.bfloat16),
        "meta/str": np.array([b"hello", b"", b"x" * 300, "é".encode()], object),
        "meta/empty": np.zeros((0, 3), np.float32),
        "meta/scalar": np.float32(2.5),
        "big/Momentum": rng.randn(64, 300).astype(np.float32),
    }


def save(prefix, vals, slices=None):
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    names = sorted(vals)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[(slices or {}).get(n, "") for n in names],
                      tensors=[v if isinstance(v, tf.Tensor) else tf.constant(v)
                               for v in (vals[n] for n in names)])


def read(prefix):
    r = tf.train.load_checkpoint(prefix)
    out = {}
    for name, dtype in r.get_variable_to_dtype_map().items():
        v = r.get_tensor(name)
        if dtype == tf.bfloat16:
            v = np.asarray(v).astype(np.float32)
        out[name] = np.asarray(v)
    return out


def main():
    out, prefixes = sys.argv[1], sys.argv[2:]
    vals = values()
    save(os.path.join(out, "one", "ckpt"), vals)
    names = sorted(vals)
    for i, half in enumerate((names[::2], names[1::2])):
        save(os.path.join(out, f"part{i}", "p"), {n: vals[n] for n in half})
    tf.raw_ops.MergeV2Checkpoints(
        checkpoint_prefixes=[os.path.join(out, f"part{i}", "p") for i in range(2)],
        destination_prefix=os.path.join(out, "two", "merged"), delete_old_dirs=False)
    save(os.path.join(out, "uint8", "ckpt"), {"w": np.arange(5, dtype=np.float32),
                                              "odd/uint8": np.arange(6, dtype=np.uint8)})
    save(os.path.join(out, "sliced", "ckpt"), {"part": np.ones((2, 3), np.float32)},
         slices={"part": "4 3 0,2:-"})
    read_back = {p: read(p) for p in (os.path.join(out, "one", "ckpt"),
                                      os.path.join(out, "two", "merged"), *prefixes)}
    with open(os.path.join(out, "read.pkl"), "wb") as f:
        pickle.dump(read_back, f)


if __name__ == "__main__":
    main()
