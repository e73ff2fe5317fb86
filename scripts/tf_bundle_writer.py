#!/usr/bin/env python3
"""Write TensorFlow tensor-bundle V2 checkpoints from numpy arrays, without
TensorFlow: the ``.index`` LevelDB-format table and the
``.data-<shard>-of-<n>`` files that ``tf.train.load_checkpoint`` and the
port's reader (``voxsrc2020_speaker_verification_tpu_torch/utils/tf_bundle.py``)
read.

It is a test tool: the tests and ``chip_smoke.py`` build reference-format
checkpoints with it (the CPU tests hold its output to
``tf.train.load_checkpoint``), so the import path is exercised where no
released TF checkpoint and no TensorFlow are present.

    import tf_bundle_writer
    tf_bundle_writer.write_bundle("/tmp/ckpt/model.ckpt-100",
                                  {"conv2d/kernel": w, "global_step": np.int64(100)})

Arrays keep their dtype: float32, float64, int32, int64, bool, float16;
names in ``bfloat16`` are stored as bfloat16 (rounded to nearest even from
float32); object arrays of bytes are string tensors. With ``num_shards`` > 1
the variables go to the shards in turn, by sorted name.
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from voxsrc2020_speaker_verification_tpu_torch.utils.tf_bundle import (  # noqa: E402
    TABLE_MAGIC, crc32c, data_path, mask_crc)

DT_CODES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3,
            np.dtype(np.int64): 9, np.dtype(np.bool_): 10, np.dtype(np.float16): 19}
DT_STRING, DT_BFLOAT16 = 7, 14
RESTART_INTERVAL = 16


def varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, v: int) -> bytes:
    return varint(num << 3) + varint(v) if v else b""


def field_bytes(num: int, b: bytes) -> bytes:
    return varint(num << 3 | 2) + varint(len(b)) + b


def shape_proto(shape) -> bytes:
    return b"".join(field_bytes(2, field_varint(1, int(d))) for d in shape)


def entry_proto(dtype: int, shape, shard: int, offset: int, size: int, crc: int) -> bytes:
    return (field_varint(1, dtype) + field_bytes(2, shape_proto(shape)) + field_varint(3, shard)
            + field_varint(4, offset) + field_varint(5, size)
            + varint(6 << 3 | 5) + struct.pack("<I", crc))


def header_proto(num_shards: int) -> bytes:
    # num_shards = 1, endianness = 2 (LITTLE = 0, the default), version = 3 {producer = 1}
    return field_varint(1, num_shards) + field_bytes(3, field_varint(1, 1))


def tensor_bytes(value: np.ndarray, bf16: bool) -> Tuple[int, bytes, int]:
    """(dtype code, stored bytes, unmasked CRC32C of what the entry covers)."""
    if value.dtype == object:
        # varint lengths, the masked CRC of the lengths as uint32, the bytes;
        # the entry's CRC covers the uint32 lengths in place of the varints
        items = [bytes(x) for x in value.reshape(-1)]
        lengths32 = b"".join(struct.pack("<I", len(x)) for x in items)
        tail = struct.pack("<I", mask_crc(crc32c(lengths32))) + b"".join(items)
        raw = b"".join(varint(len(x)) for x in items) + tail
        return DT_STRING, raw, crc32c(lengths32 + tail)
    if bf16:
        bits = np.ascontiguousarray(value, np.float32).view(np.uint32)
        rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
        raw = rounded.astype("<u2").tobytes()
        return DT_BFLOAT16, raw, crc32c(raw)
    dt = np.dtype(value.dtype)
    if dt not in DT_CODES:
        raise ValueError(f"tf_bundle_writer: dtype {dt} is not written")
    raw = np.ascontiguousarray(value, dt.newbyteorder("<")).tobytes()
    return DT_CODES[dt], raw, crc32c(raw)


def block(entries: Iterable[Tuple[bytes, bytes]]) -> bytes:
    """One LevelDB block: prefix-compressed entries, restart every 16."""
    out, restarts, last = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        if i % RESTART_INTERVAL == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while shared < min(len(last), len(key)) and last[shared] == key[shared]:
                shared += 1
        out += varint(shared) + varint(len(key) - shared) + varint(len(value))
        out += key[shared:] + value
        last = key
    restarts = restarts or [0]
    out += b"".join(struct.pack("<I", r) for r in restarts) + struct.pack("<I", len(restarts))
    return bytes(out)


def write_table(path: str, items: List[Tuple[bytes, bytes]], block_size: int = 4096) -> None:
    """A LevelDB-format table of ``items`` (sorted by key): data blocks of
    about ``block_size`` bytes, an empty metaindex block, the index block
    (each data block's last key -> its handle) and the 48-byte footer."""
    items = sorted(items)
    f = bytearray()

    def put(contents: bytes) -> bytes:
        handle = varint(len(f)) + varint(len(contents))
        f.extend(contents)
        f.extend(b"\0" + struct.pack("<I", mask_crc(crc32c(contents + b"\0"))))
        return handle

    index, pending, size = [], [], 0
    for key, value in items:
        pending.append((key, value))
        size += len(key) + len(value) + 8
        if size >= block_size:
            index.append((pending[-1][0], put(block(pending))))
            pending, size = [], 0
    if pending:
        index.append((pending[-1][0], put(block(pending))))
    meta = put(block([]))
    idx = put(block(index))
    footer = (meta + idx).ljust(40, b"\0")
    footer += struct.pack("<II", TABLE_MAGIC & 0xFFFFFFFF, TABLE_MAGIC >> 32)
    f.extend(footer)
    with open(path, "wb") as out:
        out.write(bytes(f))


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray], num_shards: int = 1,
                 bfloat16: Optional[Iterable[str]] = None, block_size: int = 4096) -> int:
    """Write ``tensors`` as a checkpoint at ``prefix``; returns the bytes of
    the data shards."""
    bf16 = set(bfloat16 or ())
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    shards = [open(data_path(prefix, s, num_shards), "wb") for s in range(num_shards)]
    offsets = [0] * num_shards
    items = [(b"", header_proto(num_shards))]
    try:
        for i, name in enumerate(sorted(tensors)):
            value = np.asarray(tensors[name])
            dtype, raw, crc = tensor_bytes(value, name in bf16)
            shard = i % num_shards
            shards[shard].write(raw)
            items.append((name.encode(), entry_proto(dtype, value.shape, shard, offsets[shard],
                                                     len(raw), mask_crc(crc))))
            offsets[shard] += len(raw)
    finally:
        for s in shards:
            s.close()
    write_table(prefix + ".index", items, block_size)
    return sum(offsets)


# ---------------------------------------------------------------------------
# the port's weights as a reference checkpoint's variables
# ---------------------------------------------------------------------------

def port_key(collection: str, path: Tuple[str, ...]) -> str:
    """The state_dict key that ``convert.from_flax`` gives a flax path."""
    if collection == "batch_stats":
        return ".".join(path[:-2] + ("running_" + path[-1],))
    mod = path[:-1]
    if mod and mod[-1] in ("conv", "dense"):
        mod = mod[:-1]
    return ".".join(mod + ("weight",))


def to_reference(value) -> np.ndarray:
    """A port tensor in the reference's layout: conv OIHW -> HWIO, dense
    (out, in) -> (in, out)."""
    a = np.asarray(value.detach().cpu() if hasattr(value, "detach") else value, np.float32)
    if a.ndim == 4:
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return a


def reference_snapshot(state_dict, model: str, projection_id: Optional[str] = "sc_cm_linear",
                       momentum=None, step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``{tf_var_name: array}`` of a reference checkpoint holding the port's
    ``state_dict`` (a SpeakerNet's, ``projection.kernel`` included where
    ``projection_id`` is given): the inverse of ``utils/tf_import.py``'s name
    map, with ``<var>/Momentum`` slots from ``momentum`` (keyed like the
    state_dict) and ``global_step``."""
    from voxsrc2020_speaker_verification_tpu_torch.utils.tf_import import reference_var_map

    snap = {}
    for tf_name, (col, path) in reference_var_map(model).items():
        key = port_key(col, ("encoder",) + path)
        snap[tf_name] = to_reference(state_dict[key])
        if momentum is not None and col == "params":
            snap[tf_name + "/Momentum"] = to_reference(momentum[key])
    if projection_id:
        kernel = state_dict["projection.kernel"]
        snap[f"{projection_id}/kernel"] = np.asarray(kernel.detach().cpu(), np.float32)
        if momentum is not None:
            snap[f"{projection_id}/kernel/Momentum"] = np.asarray(
                momentum["projection.kernel"].detach().cpu(), np.float32)
    if step is not None:
        snap["global_step"] = np.asarray(step, np.int64)
    return snap
