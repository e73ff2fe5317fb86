"""Kaldi table IO: ark/scp readers and writers.

The port's copy of the JAX package's ``data/kaldi_io.py`` (which imports no
JAX, but the port imports nothing of that package): the same bytes written
and the same arrays read, held against it by tests/test_torch_data.py.
From-scratch readers and writers of the publicly documented Kaldi binary
table formats (https://kaldi-asr.org/doc/io.html):

* binary float/double matrices ('FM '/'DM ') and float vectors ('FV '/'DV ')
* compressed matrices ('CM ': global min/range + per-column uint16
  percentile headers + uint8 codes, col-major), read and written, the
  format the feature stores keep
* scp indirection with byte offsets ("path:12345"), ark,scp paired writing

No Kaldi binaries are piped through: features are computed by the package
itself (``ops/fbank.py``), so plain files are the only transport needed. A
``cmd |`` rspec is still accepted for interop with external toolchains.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import subprocess
from typing import BinaryIO, Dict, Iterator, Tuple, Union

import numpy as np

_UINT16_SCALE = 1.0 / 65535.0


def open_or_fd(file_or_fd: Union[str, BinaryIO], mode: str = "rb"):
    """Open a path, 'path:offset', gzip file, or '...|' / '|...' pipe."""
    if not isinstance(file_or_fd, str):
        return file_or_fd
    spec = file_or_fd
    # strip 'ark:' / 'scp:' style prefixes
    for prefix in ("ark,scp:", "scp:", "ark:"):
        if spec.startswith(prefix):
            spec = spec[len(prefix):]
            break
    if spec.rstrip().endswith("|"):
        proc = subprocess.Popen(spec.rstrip()[:-1], shell=True, stdout=subprocess.PIPE)
        return proc.stdout
    if spec.lstrip().startswith("|"):
        proc = subprocess.Popen(spec.lstrip()[1:], shell=True, stdin=subprocess.PIPE)
        return proc.stdin
    offset = None
    path = spec
    if ":" in spec:
        maybe_path, _, maybe_off = spec.rpartition(":")
        if maybe_off.isdigit() and os.path.exists(maybe_path):
            path, offset = maybe_path, int(maybe_off)
    if path.endswith(".gz"):
        fd = gzip.open(path, mode)
    else:
        fd = open(path, mode)
    if offset is not None:
        fd.seek(offset)
    return fd


def read_key(fd: BinaryIO) -> str:
    """Read a whitespace-terminated utterance key ('' at EOF)."""
    chars = []
    while True:
        c = fd.read(1)
        if c == b"" or c in b" \t\n":
            break
        chars.append(c)
    return b"".join(chars).decode()


def _expect_binary(fd: BinaryIO) -> None:
    marker = fd.read(2)
    if marker != b"\0B":
        raise ValueError(f"expected binary marker, got {marker!r} "
                         "(ascii tables not supported)")


def _read_int32(fd: BinaryIO) -> int:
    size_marker = fd.read(1)
    assert size_marker == b"\x04", size_marker
    return struct.unpack("<i", fd.read(4))[0]


def _write_int32(fd: BinaryIO, v: int) -> None:
    fd.write(b"\x04" + struct.pack("<i", v))


def read_mat(fd: BinaryIO) -> np.ndarray:
    _expect_binary(fd)
    header = fd.read(3).decode()
    if header.startswith("CM"):
        return _read_compressed_mat(fd, header)
    if header == "FM ":
        dtype, size = np.float32, 4
    elif header == "DM ":
        dtype, size = np.float64, 8
    else:
        raise ValueError(f"unknown matrix header {header!r}")
    rows = _read_int32(fd)
    cols = _read_int32(fd)
    buf = fd.read(rows * cols * size)
    return np.frombuffer(buf, dtype=dtype).reshape(rows, cols)


def _read_compressed_mat(fd: BinaryIO, header: str) -> np.ndarray:
    if header != "CM ":
        raise ValueError(f"unsupported compressed format {header!r}")
    gmin, grange = struct.unpack("<ff", fd.read(8))
    rows, cols = struct.unpack("<ii", fd.read(8))
    pct = np.frombuffer(fd.read(cols * 8), dtype=np.uint16).reshape(cols, 4)
    pct = pct.astype(np.float32) * (grange * _UINT16_SCALE) + gmin  # (C, 4)
    codes = np.frombuffer(fd.read(cols * rows), dtype=np.uint8).reshape(cols, rows)

    p0, p25, p75, p100 = (pct[:, i: i + 1] for i in range(4))
    c = codes.astype(np.float32)
    # Kaldi CharToFloat: three linear segments over code ranges
    # [0,64], (64,192], (192,255].
    low = p0 + (p25 - p0) * (c / 64.0)
    mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
    high = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
    out = np.where(codes <= 64, low, np.where(codes <= 192, mid, high))
    return out.T.astype(np.float32)  # stored col-major


def write_mat(fd: BinaryIO, mat: np.ndarray, key: str = "", compress: bool = False):
    if key:
        fd.write((key + " ").encode())
    fd.write(b"\0B")
    if compress:
        _write_compressed_mat(fd, np.asarray(mat, np.float32))
        return
    mat = np.asarray(mat)
    if mat.dtype == np.float32:
        fd.write(b"FM ")
    elif mat.dtype == np.float64:
        fd.write(b"DM ")
    else:
        raise ValueError(mat.dtype)
    _write_int32(fd, mat.shape[0])
    _write_int32(fd, mat.shape[1])
    fd.write(mat.tobytes())


def _column_percentiles(col_sorted: np.ndarray) -> Tuple[float, float, float, float]:
    """Kaldi ComputeColHeader quantile positions for one sorted column."""
    n = len(col_sorted)
    if n >= 5:
        quarter = n // 4
        return (col_sorted[0], col_sorted[quarter],
                col_sorted[3 * quarter], col_sorted[n - 1])
    return (col_sorted[0], col_sorted[min(1, n - 1)],
            col_sorted[max(n - 2, 0)], col_sorted[n - 1])


def _write_compressed_mat(fd: BinaryIO, mat: np.ndarray) -> None:
    """Write 'CM ' format (one-byte-per-value, format 1)."""
    rows, cols = mat.shape
    gmin = float(mat.min())
    grange = float(mat.max()) - gmin
    if grange == 0.0:
        grange = 1e-5  # avoid zero range (Kaldi guards similarly)
    fd.write(b"CM ")
    fd.write(struct.pack("<ff", gmin, grange))
    fd.write(struct.pack("<ii", rows, cols))

    def to_u16(v):
        return np.clip((v - gmin) / grange * 65535.0 + 0.499, 0, 65535).astype(np.uint16)

    srt = np.sort(mat, axis=0)  # (rows, cols), each column sorted
    pcts = np.zeros((cols, 4), np.float32)
    for j in range(cols):
        pcts[j] = _column_percentiles(srt[:, j])
    pct_u16 = to_u16(pcts)
    # Re-derive the float percentile values the decoder will see.
    pct_f = pct_u16.astype(np.float32) * (grange * _UINT16_SCALE) + gmin
    fd.write(pct_u16.tobytes())

    p0, p25, p75, p100 = (pct_f[:, i] for i in range(4))  # (C,)
    x = mat.T  # (C, R) col-major encode
    with np.errstate(divide="ignore", invalid="ignore"):
        low = np.clip((x - p0[:, None]) / np.where(
            (p25 - p0)[:, None] == 0, 1, (p25 - p0)[:, None]) * 64.0 + 0.5, 0, 64)
        mid = np.clip((x - p25[:, None]) / np.where(
            (p75 - p25)[:, None] == 0, 1, (p75 - p25)[:, None]) * 128.0 + 64.5, 65, 192)
        high = np.clip((x - p75[:, None]) / np.where(
            (p100 - p75)[:, None] == 0, 1, (p100 - p75)[:, None]) * 63.0 + 192.5, 193, 255)
    codes = np.where(
        x <= p25[:, None], low, np.where(x <= p75[:, None], mid, high)
    ).astype(np.uint8)
    fd.write(codes.tobytes())


def read_vec_flt(fd: BinaryIO) -> np.ndarray:
    _expect_binary(fd)
    header = fd.read(3).decode()
    if header == "FV ":
        dtype, size = np.float32, 4
    elif header == "DV ":
        dtype, size = np.float64, 8
    else:
        raise ValueError(f"unknown vector header {header!r}")
    dim = _read_int32(fd)
    return np.frombuffer(fd.read(dim * size), dtype=dtype)


def write_vec_flt(fd: BinaryIO, vec: np.ndarray, key: str = "") -> None:
    if key:
        fd.write((key + " ").encode())
    fd.write(b"\0B")
    vec = np.asarray(vec)
    if vec.dtype == np.float32:
        fd.write(b"FV ")
    elif vec.dtype == np.float64:
        fd.write(b"DV ")
    else:
        raise ValueError(vec.dtype)
    _write_int32(fd, vec.shape[0])
    fd.write(vec.tobytes())


def _iter_ark(file_or_fd, read_one) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(file_or_fd)
    try:
        while True:
            key = read_key(fd)
            if not key:
                break
            yield key, read_one(fd)
    finally:
        if fd is not file_or_fd:
            fd.close()


def read_mat_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    return _iter_ark(file_or_fd, read_mat)


def read_vec_flt_ark(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    return _iter_ark(file_or_fd, read_vec_flt)


def _iter_scp(file_or_fd) -> Iterator[Tuple[str, str]]:
    fd = open_or_fd(file_or_fd, "rb")
    try:
        for line in fd:
            key, rxfile = line.decode().strip().split(maxsplit=1)
            yield key, rxfile
    finally:
        if fd is not file_or_fd:
            fd.close()


def _split_rxfile(rxfile: str):
    """'path:offset' -> (path, offset) for plain-file scp entries, else None
    (pipes and offset-less paths take the generic open_or_fd route)."""
    if rxfile.endswith("|") or rxfile.startswith("|"):
        return None
    path, sep, off = rxfile.rpartition(":")
    if sep and off.isdigit():
        return path, int(off)
    return None


def read_mat_scp(file_or_fd, use_native: bool = True) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) over an scp.  Plain `path:offset` entries go
    through the native C++ decoder (native/vox_io.cc, ``data/native.py``)
    when it is available -- the feeder hot path; pipes and exotic rspecs
    take the Python reader."""
    native_mod = None
    if use_native:
        from . import native as native_mod
        if not native_mod.available():
            native_mod = None
    for key, rxfile in _iter_scp(file_or_fd):
        split = _split_rxfile(rxfile) if native_mod else None
        if split is not None:
            yield key, native_mod.read_mat(split[0], split[1])
        else:
            with open_or_fd(rxfile) as fd:
                yield key, read_mat(fd)


def read_vec_flt_scp(file_or_fd) -> Iterator[Tuple[str, np.ndarray]]:
    for key, rxfile in _iter_scp(file_or_fd):
        with open_or_fd(rxfile) as fd:
            yield key, read_vec_flt(fd)


class ArkScpWriter:
    """Paired ark+scp writer (the 'ark,scp:a.ark,a.scp' wspec)."""

    def __init__(self, ark_path: str, scp_path: str, compress: bool = False):
        self.ark_path = os.path.abspath(ark_path)
        self.ark = open(ark_path, "wb")
        self.scp = open(scp_path, "w")
        self.compress = compress

    def write(self, key: str, array: np.ndarray) -> None:
        self.ark.write((key + " ").encode())
        offset = self.ark.tell()
        if array.ndim == 2:
            write_mat(self.ark, array, compress=self.compress)
        else:
            write_vec_flt(self.ark, array)
        self.scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self):
        self.ark.close()
        self.scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_all(reader: Iterator[Tuple[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: v for k, v in reader}
