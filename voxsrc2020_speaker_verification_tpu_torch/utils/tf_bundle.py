"""Reader of TensorFlow's tensor-bundle V2 checkpoints, in numpy and the
standard library (the port imports no TensorFlow).

A checkpoint ``<prefix>`` is ``<prefix>.index`` and the data shards
``<prefix>.data-<shard>-of-<n>``. The index is a LevelDB-format table:

* a 48-byte footer: the metaindex and index block handles (varint64
  offset and size each), zero padding to 40 bytes, then the magic
  ``0xdb4775248b80fb57`` as two little-endian fixed32;
* an index block whose values are the data blocks' handles;
* blocks of prefix-compressed entries (varint32 shared, non-shared and
  value lengths, the key's new bytes, the value), then the restart offsets
  (fixed32 each) and their count (fixed32); every block is followed by a
  5-byte trailer: its compression type (0, none, is the only one read) and
  the masked CRC32C of the block and that byte.

The entry under key ``""`` is a ``BundleHeaderProto`` (num_shards = 1,
endianness = 2, version = 3); every other key is a variable's
``BundleEntryProto`` (dtype = 1, shape = 2, shard_id = 3, offset = 4,
size = 5, crc32c = 6 (fixed32), slices = 7). A tensor's bytes sit in its
shard at [offset, offset + size), little-endian, and their masked CRC32C
must equal ``crc32c``, as TF's ``BundleReader`` checks. A string tensor is
stored as the elements' varint64 lengths, the masked CRC32C of those
lengths (each taken as a little-endian uint32), then the bytes; its entry
CRC covers the uint32 lengths, that checksum and the bytes.

CRC32C (Castagnoli) runs in numpy: the bytes are split into equal chunks
advanced in lockstep four bytes a step through slicing-by-4 tables, and the
chunks' CRCs are combined pairwise with the GF(2) operator that appends
zeros (:func:`crc32c`).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
_MASK_DELTA = 0xA282EAD8
_POLY = 0x82F63B78  # CRC32C, reflected

# TF's DataType enum -> numpy dtype of the stored bytes (bfloat16 is read as
# uint16 and widened to float32)
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 9: np.dtype("<i8"),
          10: np.dtype(np.bool_), 14: np.dtype("<u2"), 19: np.dtype("<f2")}
DT_STRING, DT_BFLOAT16 = 7, 14
DTYPE_NAMES = {1: "float32", 2: "float64", 3: "int32", 7: "string", 9: "int64", 10: "bool",
               14: "bfloat16", 19: "float16"}


class BundleError(ValueError):
    """A checkpoint that is corrupt, or holds something the reader does not take."""


# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

def _tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The byte-wise table (256,) and the two 16-bit tables (65536,) that
    advance a register over one little-endian 32-bit word: after
    ``r ^= word``, ``r = LO[r & 0xffff] ^ HI[r >> 16]`` (slicing-by-4, its
    byte tables merged in pairs)."""
    t0 = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t0 = np.where(t0 & 1, (t0 >> 1) ^ np.uint32(_POLY), t0 >> 1).astype(np.uint32)
    rows = [t0]
    for _ in range(3):
        prev = rows[-1]
        rows.append((prev >> 8) ^ t0[prev & 0xFF])
    x = np.arange(1 << 16, dtype=np.uint32)
    lo = rows[3][x & 0xFF] ^ rows[2][x >> 8]
    hi = rows[1][x & 0xFF] ^ rows[0][x >> 8]
    return t0, lo, hi


_T0, _LO16, _HI16 = _tables()
_UNIT = np.uint32(1) << np.arange(32, dtype=np.uint32)


def _apply(op: np.ndarray, regs: np.ndarray) -> np.ndarray:
    """Apply a GF(2) 32x32 operator, given as the images of the 32 unit
    vectors, to uint32 registers (K,)."""
    bits = (np.asarray(regs, np.uint32)[..., None] & _UNIT) != 0
    return np.bitwise_xor.reduce(np.where(bits, op, np.uint32(0)), axis=-1).astype(np.uint32)


def _zeros_op(nbytes: int) -> np.ndarray:
    """The operator that advances a register over ``nbytes`` zero bytes
    (one zero byte: reg -> T0[reg & 0xff] ^ (reg >> 8))."""
    result = _UNIT.copy()  # identity
    square = _T0[_UNIT & 0xFF] ^ (_UNIT >> 8)
    while nbytes:
        if nbytes & 1:
            result = _apply(square, result)
        nbytes >>= 1
        if nbytes:
            square = _apply(square, square)
    return result


def crc32c(data, chunks: Optional[int] = None) -> int:
    """CRC32C of ``data`` (bytes-like or a numpy array's bytes).

    The bytes are padded in front with zeros to ``K * L`` (a register at 0
    stays 0 over zeros; the initial 0xffffffff enters as the inversion of
    the first four data bytes), split into K chunks of L bytes (L a
    multiple of 4) advanced in lockstep a word a step, and the chunk CRCs
    combined pairwise: crc(A || B) = zeros_op(len B)(crc A) ^ crc B. The
    result is inverted at the end. ``chunks`` (K, rounded up to a power of
    two) defaults to about n / 1024, at most 65536."""
    buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    n = buf.size
    if n < 4:
        reg = 0xFFFFFFFF
        for b in buf.tolist():
            reg = int(_T0[(reg ^ b) & 0xFF]) ^ (reg >> 8)
        return reg ^ 0xFFFFFFFF
    if chunks is None:
        chunks = min(1 << 16, max(1, n >> 10))
    k = 1 << (max(1, chunks) - 1).bit_length()
    length = 4 * -(-n // (4 * k))  # ceil(n / k), rounded up to a multiple of 4
    padded = np.zeros(k * length, np.uint8)
    start = k * length - n
    padded[start:] = buf
    padded[start:start + 4] ^= 0xFF
    words = np.ascontiguousarray(padded.view("<u4").reshape(k, length // 4).T)
    reg = np.zeros(k, np.uint32)
    for w in words:
        r = reg ^ w
        reg = _LO16[r & 0xFFFF] ^ _HI16[r >> 16]
    op = _zeros_op(length)
    while reg.size > 1:
        reg = _apply(op, reg[0::2]) ^ reg[1::2]
        op = _apply(op, op)
    return int(reg[0]) ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """LevelDB's and TF's masked CRC: rotate right by 15, add a constant."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire format and varints
# ---------------------------------------------------------------------------

def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, next position) of a base-128 varint."""
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise BundleError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise BundleError("varint longer than 10 bytes")


def proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a serialized message: ints for
    varint (0) and fixed32 (5) / fixed64 (1), bytes for length-delimited (2)."""
    pos = 0
    while pos < len(buf):
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = read_varint(buf, pos)
        elif wire == 1:
            value, = struct.unpack_from("<Q", buf, pos)
            pos += 8
        elif wire == 2:
            n, pos = read_varint(buf, pos)
            if pos + n > len(buf):
                raise BundleError("truncated length-delimited field")
            value = bytes(buf[pos:pos + n])
            pos += n
        elif wire == 5:
            value, = struct.unpack_from("<I", buf, pos)
            pos += 4
        else:
            raise BundleError(f"unsupported wire type {wire}")
        yield field, wire, value


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2 (Dim: int64 size = 1)."""
    dims = []
    for field, _, value in proto_fields(buf):
        if field == 2:
            size = 0
            for f, _, v in proto_fields(value):
                if f == 1:
                    size = _signed64(v)
            dims.append(size)
        elif field == 3 and value:
            raise BundleError("tensor shape of unknown rank")
    return tuple(dims)


def parse_entry(buf: bytes) -> dict:
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0, "crc32c": None,
             "slices": 0}
    for field, _, value in proto_fields(buf):
        if field == 1:
            entry["dtype"] = value
        elif field == 2:
            entry["shape"] = parse_shape(value)
        elif field == 3:
            entry["shard_id"] = value
        elif field == 4:
            entry["offset"] = _signed64(value)
        elif field == 5:
            entry["size"] = _signed64(value)
        elif field == 6:
            entry["crc32c"] = value
        elif field == 7:
            entry["slices"] += 1
    return entry


def parse_header(buf: bytes) -> dict:
    header = {"num_shards": 0, "endianness": 0, "producer": 0}
    for field, _, value in proto_fields(buf):
        if field == 1:
            header["num_shards"] = value
        elif field == 2:
            header["endianness"] = value
        elif field == 3:
            for f, _, v in proto_fields(value):
                if f == 1:
                    header["producer"] = v
    return header


# ---------------------------------------------------------------------------
# the LevelDB table of the .index file
# ---------------------------------------------------------------------------

def _read_block(data: bytes, offset: int, size: int, what: str) -> bytes:
    end = offset + size
    if end + 5 > len(data):
        raise BundleError(f"{what}: block at {offset} (+{size}) runs past the index file")
    block = data[offset:end]
    kind = data[end]
    if kind != 0:
        raise BundleError(f"{what}: block at {offset} has compression type {kind}; only "
                          f"uncompressed (0) blocks are read")
    stored, = struct.unpack_from("<I", data, end + 1)
    if mask_crc(crc32c(data[offset:end + 1])) != stored:
        raise BundleError(f"{what}: block at {offset} fails its CRC32C")
    return block


def block_entries(block: bytes, what: str) -> List[Tuple[bytes, bytes]]:
    """[(key, value)] of one block, keys rebuilt from their shared prefixes."""
    if len(block) < 4:
        raise BundleError(f"{what}: block shorter than its restart count")
    num_restarts, = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 - 4 * num_restarts
    if limit < 0:
        raise BundleError(f"{what}: bad restart count {num_restarts}")
    out, key, pos = [], b"", 0
    while pos < limit:
        shared, pos = read_varint(block, pos)
        non_shared, pos = read_varint(block, pos)
        value_len, pos = read_varint(block, pos)
        if shared > len(key) or pos + non_shared + value_len > limit:
            raise BundleError(f"{what}: corrupt entry at {pos}")
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        out.append((key, block[pos:pos + value_len]))
        pos += value_len
    return out


def read_index(path: str) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of a LevelDB-format table file, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise BundleError(f"{path}: shorter than a table footer")
    footer = data[-FOOTER_BYTES:]
    lo, hi = struct.unpack_from("<II", footer, FOOTER_BYTES - 8)
    if (hi << 32 | lo) != TABLE_MAGIC:
        raise BundleError(f"{path}: not a TF bundle index (bad table magic)")
    _, pos = read_varint(footer, 0)   # metaindex offset
    _, pos = read_varint(footer, pos)  # metaindex size
    index_offset, pos = read_varint(footer, pos)
    index_size, pos = read_varint(footer, pos)
    entries = []
    for _, handle in block_entries(_read_block(data, index_offset, index_size,
                                               f"{path} index block"), f"{path} index block"):
        offset, p = read_varint(handle, 0)
        size, _ = read_varint(handle, p)
        what = f"{path} data block"
        entries.extend(block_entries(_read_block(data, offset, size, what), what))
    return entries


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------

def data_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def _decode_strings(name: str, raw: bytes, count: int) -> Tuple[np.ndarray, bytes]:
    """(the elements as an object array of bytes, the bytes the entry's CRC
    covers: the lengths as uint32, their masked CRC, the elements)."""
    lengths, pos = [], 0
    for _ in range(count):
        n, pos = read_varint(raw, pos)
        lengths.append(n)
    if pos + 4 > len(raw):
        raise BundleError(f"{name}: string tensor truncated")
    stored = raw[pos:pos + 4]
    length_bytes = b"".join(struct.pack("<I" if n <= 0xFFFFFFFF else "<Q", n) for n in lengths)
    if mask_crc(crc32c(length_bytes)) != struct.unpack("<I", stored)[0]:
        raise BundleError(f"{name}: string lengths fail their CRC32C")
    start = pos = pos + 4
    out = np.empty(count, object)
    for i, n in enumerate(lengths):
        out[i] = bytes(raw[pos:pos + n])
        pos += n
    if pos != len(raw):
        raise BundleError(f"{name}: string tensor is {len(raw)} bytes, its elements {pos}")
    return out, length_bytes + stored + raw[start:]


class BundleReader:
    """Random access to a bundle's variables. ``entries`` maps each
    variable name to its parsed ``BundleEntryProto``."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = prefix + ".index"
        if not os.path.exists(index):
            raise FileNotFoundError(f"no TF checkpoint index {index}")
        table = dict(read_index(index))
        if b"" not in table:
            raise BundleError(f"{index}: no bundle header (empty key)")
        self.header = parse_header(table.pop(b""))
        if self.header["endianness"] != 0:
            raise BundleError(f"{index}: big-endian bundles are not read")
        self.num_shards = self.header["num_shards"]
        # keys starting with a zero byte hold the slices of partitioned
        # variables (TF's encoded tensor-name-and-slice keys), not variables
        self.entries = {k.decode("utf-8", "backslashreplace"): parse_entry(v)
                        for k, v in table.items() if not k.startswith(b"\0")}
        self.bytes_read = 0

    def names(self) -> List[str]:
        return sorted(self.entries)

    def raw_bytes(self, name: str) -> bytes:
        """A variable's stored bytes, unchecked."""
        e = self.entries[name]
        if e["slices"]:
            raise BundleError(f"{name}: a partitioned (sliced) variable; slices are not read")
        path = data_path(self.prefix, e["shard_id"], self.num_shards)
        with open(path, "rb") as f:
            f.seek(e["offset"])
            raw = f.read(e["size"])
        if len(raw) != e["size"]:
            raise BundleError(f"{name}: {path} ends before the tensor's {e['size']} bytes")
        self.bytes_read += len(raw)
        return raw

    def _check_crc(self, name: str, covered) -> None:
        e = self.entries[name]
        if e["crc32c"] is None:
            raise BundleError(f"{name}: entry has no crc32c")
        if mask_crc(crc32c(covered)) != e["crc32c"]:
            path = data_path(self.prefix, e["shard_id"], self.num_shards)
            raise BundleError(f"{name}: data CRC32C mismatch in {path} (offset {e['offset']}, "
                              f"{e['size']} bytes)")

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self.entries:
            raise KeyError(f"{name!r} is not in {self.prefix}")
        e = self.entries[name]
        shape, dtype = e["shape"], e["dtype"]
        count = int(np.prod(shape, dtype=np.int64))
        if dtype != DT_STRING and dtype not in DTYPES:
            raise BundleError(f"{name}: dtype {dtype} (TF DataType enum) is not read; the "
                              f"reader takes {sorted(DTYPE_NAMES.values())}")
        raw = self.raw_bytes(name)
        if dtype == DT_STRING:
            strings, covered = _decode_strings(name, raw, count)
            self._check_crc(name, covered)
            return strings.reshape(shape)
        self._check_crc(name, raw)
        want = count * DTYPES[dtype].itemsize
        if len(raw) != want:
            raise BundleError(f"{name}: {len(raw)} bytes for {DTYPE_NAMES[dtype]} {shape}")
        out = np.frombuffer(raw, DTYPES[dtype]).reshape(shape)
        if dtype == DT_BFLOAT16:
            return (out.astype(np.uint32) << 16).view(np.float32)
        return out.astype(DTYPES[dtype].newbyteorder("="))

    def read_all(self) -> Dict[str, np.ndarray]:
        return {name: self.get_tensor(name) for name in self.names()}


def load_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """Every variable of a tensor-bundle checkpoint, ``{name: ndarray}``."""
    return BundleReader(prefix).read_all()
