"""ctypes bindings of the native IO library (``native/vox_io.cc``,
``native/vox_feeder.cc``, ``native/vox_raw.cc``), the port's counterpart of
the JAX package's ``data/native.py``.

The feature-shard training feeder's whole hot loop -- seek into an ark,
decode an FM/CM matrix, sliding CMN, crop or pad, batch assembly and the
bf16 wire -- runs in a C++ thread pool with the GIL released; one ctypes
call fills an optimizer step's batch. ``kaldi_io`` and
``dataset.FeatureShardDataset`` are the Python versions of the same work.

The library is built on first use by ``make -C native`` into
``native/libvox_io.so`` (under the lock file ``native/.build.lock``, so
processes that start together build it once) and loaded from there.
``read_wav`` and ``render_spec`` bind the library's wav reader
(``native/vox_io.cc``) and augmentation-spec renderer
(``native/vox_raw.cc``), the C++ versions of
``data/audio.py:read_wav`` (16-bit PCM only) and
``data/augment.py:load_utterance``. ``NativeRawBatchFeeder`` binds the
raw-audio training feeder of ``native/vox_raw.cc`` (wav decode, spec
rendering, int16 crop with CMN context, batch assembly), the C++ version of
``BatchFeeder`` over ``data/raw_dataset.py:RawAudioShardDataset`` sources.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvox_io.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """``make -C native`` (a no-op when the library is newer than its
    sources), serialized across processes by a lock file."""
    try:
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                           capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception as e:
        if os.path.exists(_LIB_PATH):  # a stale library beats none, but say so
            warnings.warn(f"native build failed ({e!r}); loading the existing "
                          "libvox_io.so, which may predate the current sources")
            return True
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library (built if needed), or None where it cannot be
    built. ``make`` always runs first, so a library older than its sources
    is rebuilt rather than loaded with an old C ABI."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.vox_read_mat.restype = ctypes.c_int
        lib.vox_read_mat.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(f32p), i32p, i32p]
        lib.vox_read_vec.restype = ctypes.c_int
        lib.vox_read_vec.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(f32p), i32p]
        for fn in ("vox_read_wav", "vox_render_spec"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_char_p, ctypes.POINTER(f32p),
                                         ctypes.POINTER(ctypes.c_int64), i32p]
        lib.vox_free.restype = None
        lib.vox_free.argtypes = [ctypes.c_void_p]
        lib.vox_feeder_create.restype = ctypes.c_void_p
        lib.vox_feeder_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64), i32p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            f32p,  # cmvn_mean (nullable)
            f32p,  # cmvn_std (nullable)
        ]
        lib.vox_feeder_next.restype = ctypes.c_int
        lib.vox_feeder_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i32p]
        lib.vox_raw_feeder_create.restype = ctypes.c_void_p
        lib.vox_raw_feeder_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), i32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32]
        lib.vox_raw_feeder_next.restype = ctypes.c_int
        lib.vox_raw_feeder_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i32p, i32p,
                                            i32p, i32p]
        for prefix in ("vox_feeder", "vox_raw_feeder"):
            getattr(lib, f"{prefix}_errors").restype = ctypes.c_int64
            getattr(lib, f"{prefix}_dead_workers").restype = ctypes.c_int32
            for fn in ("errors", "dead_workers", "stop", "destroy"):
                getattr(lib, f"{prefix}_{fn}").argtypes = [ctypes.c_void_p]
            for fn in ("stop", "destroy"):
                getattr(lib, f"{prefix}_{fn}").restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _take(lib, ptr, shape) -> np.ndarray:
    """Copy a malloc'd C buffer into numpy and free it."""
    n = int(np.prod(shape))
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).reshape(shape).copy()
    lib.vox_free(ptr)
    return arr


def _lib_or_raise() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable (make -C native failed)")
    return lib


def read_mat(path: str, offset: int = 0) -> np.ndarray:
    """Binary FM/DM/CM matrix at an ark byte offset -> (rows, cols) float32."""
    lib = _lib_or_raise()
    out = ctypes.POINTER(ctypes.c_float)()
    rows, cols = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.vox_read_mat(path.encode(), offset, ctypes.byref(out), ctypes.byref(rows),
                          ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"vox_read_mat({path}:{offset}) failed: {rc}")
    return _take(lib, out, (rows.value, cols.value))


def read_vec(path: str, offset: int = 0) -> np.ndarray:
    """Binary float vector at an ark byte offset -> (n,) float32."""
    lib = _lib_or_raise()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int32()
    rc = lib.vox_read_vec(path.encode(), offset, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"vox_read_vec({path}:{offset}) failed: {rc}")
    return _take(lib, out, (n.value,))


def _wave_call(fn: str, arg: str) -> Tuple[np.ndarray, int]:
    lib = _lib_or_raise()
    out = ctypes.POINTER(ctypes.c_float)()
    n, sr = ctypes.c_int64(), ctypes.c_int32()
    rc = getattr(lib, fn)(arg.encode(), ctypes.byref(out), ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"{fn}({arg[:120]!r}) failed: {rc}")
    return _take(lib, out, (n.value,)), sr.value


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """16-bit PCM wav -> (float32 samples in int16 scale, sample_rate);
    channels averaged to mono. Other sample widths raise IOError."""
    return _wave_call("vox_read_wav", path)


def render_spec(rxwav: str) -> Tuple[np.ndarray, int]:
    """One wav.scp value (a wav path or a JSON augmentation spec) ->
    (samples, sample_rate), rendered in C++ as
    ``data/augment.py:load_utterance`` renders it in Python."""
    return _wave_call("vox_render_spec", rxwav)


def _cmvn_rows(cmvn_pkl: str, feat_dim: int):
    """(mean, std) float32 rows of feat_dim from a global-CMVN pickle that
    holds (F,), (1, F) or scalar values, as the Python path broadcasts
    ``(feat - mean) / std``."""
    import pickle

    with open(cmvn_pkl, "rb") as f:
        mean, std = pickle.load(f)

    def row(x, what):
        x = np.asarray(x, np.float32).reshape(-1)
        if x.size == 1:
            x = np.full(feat_dim, x[0], np.float32)
        if x.size != feat_dim:
            raise ValueError(f"cmvn {what} has {x.size} dims, features have {feat_dim}")
        return np.ascontiguousarray(x)

    return row(mean, "mean"), row(std, "std")


class _NativeFeeder:
    """The lifecycle the C feeders share (``native/feeder_core.h``): one
    ctypes call a batch (``<prefix>_next``, GIL released) into fresh numpy
    buffers from ``_alloc``, ``get()`` serialized against ``close()``, and
    the health getters. ``get()`` raises IOError once every worker's block
    of the scp is dead."""

    _prefix = ""
    _dead_hint = ""

    def _init_handle(self, lib, handle) -> None:
        if not handle:
            raise ValueError(f"{self._prefix}_create refused its arguments")
        self._lib, self._handle = lib, handle
        # serializes get() against close(): destroy must not free the C++
        # object while a prefetch thread is blocked inside <prefix>_next
        self._io_lock = threading.Lock()

    def _fn(self, name: str):
        return getattr(self._lib, f"{self._prefix}_{name}")

    def _alloc(self):
        """(C arguments after the handle, the batch they fill)."""
        raise NotImplementedError

    def start(self):
        return self  # the workers start in <prefix>_create

    def get(self, timeout=None):
        # fresh buffers per batch: the device prefetch may still hold the last
        c_args, batch = self._alloc()
        with self._io_lock:
            if self._handle is None:
                raise StopIteration
            rc = self._fn("next")(self._handle, *c_args)
            if rc == -2:
                raise IOError(f"native feeder: every shard failed to decode "
                              f"({self.decode_errors()} errors): {self._dead_hint}")
        if rc != 0:
            raise StopIteration
        return batch

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def decode_errors(self) -> int:
        if self._handle is None:
            return 0
        return int(self._fn("errors")(self._handle))

    def dead_shards(self) -> int:
        """Workers whose block of the scp decoded nothing over a full pass:
        that share of the data is missing from training."""
        if self._handle is None:
            return 0
        return int(self._fn("dead_workers")(self._handle))

    def stop(self) -> None:
        """Stop the workers; the health getters still answer until close()."""
        if self._handle:
            self._fn("stop")(self._handle)

    def close(self) -> None:
        if self._handle:
            # stop outside the lock: it unblocks a get() waiting in the C
            # call, which then releases the lock
            self._fn("stop")(self._handle)
            with self._io_lock:
                if self._handle:
                    self._fn("destroy")(self._handle)
                    self._handle = None

    def __del__(self):
        # finalization only: modules may be gone at interpreter teardown
        try:
            self.close()
        except Exception:
            pass


class NativeBatchFeeder(_NativeFeeder):
    """Feature-shard training feeder in C++ (``native/vox_feeder.cc``): the
    native counterpart of ``BatchFeeder`` over ``FeatureShardDataset``
    sources. Each ``get()`` is one ctypes call (GIL released) that returns
    an optimizer step's batch: features (A, B, T, F), a float32 numpy array
    or, on the bf16 wire, a ``torch.bfloat16`` tensor (the library writes
    bf16 bit patterns, read as int16 and viewed as bfloat16), and int32
    labels (A, B). Each of ``num_threads`` workers owns a contiguous block
    of the scp entries; with one thread the batches are a function of the
    seed.

    Health: ``decode_errors()`` counts utterances that failed to decode;
    ``dead_shards()`` counts workers whose block decoded nothing over a
    full pass (``training.loop.fit`` raises on it); ``get()`` raises
    IOError once every block is dead."""

    _prefix = "vox_feeder"
    _dead_hint = "feat_dim mismatch or corrupt arks?"

    def __init__(self, scp_paths, utt2id, feat_dim: int, feat_length: int,
                 batch_size: int, num_accumulation_steps: int = 1,
                 num_threads: Optional[int] = None, seed: int = 0,
                 sliding_cmn: bool = True, cmn_window: int = 300,
                 skip_percent: int = 10, wire_bf16: bool = False,
                 cmvn_pkl: Optional[str] = None):
        from ..utils import resolve_num_workers
        from . import kaldi_io

        self._handle = None
        lib = _lib_or_raise()
        if isinstance(scp_paths, str):
            scp_paths = [scp_paths]
        paths, offsets, labels = [], [], []
        for scp in scp_paths:
            for key, rxfile in kaldi_io._iter_scp(scp):
                split = kaldi_io._split_rxfile(rxfile)
                if split is None:
                    raise ValueError(f"the native feeder takes plain path:offset scp entries, "
                                     f"got {rxfile!r} (use BatchFeeder for piped rspecs)")
                paths.append(split[0].encode())
                offsets.append(split[1])
                labels.append(int(utt2id[key]) if utt2id else 0)
        n = len(paths)
        if n == 0:
            raise ValueError(f"empty scp: {scp_paths}")
        self.a, self.b, self.t, self.f = num_accumulation_steps, batch_size, feat_length, feat_dim
        self.wire_bf16 = wire_bf16
        c_mean = c_std = None
        if cmvn_pkl:
            self._cmvn = _cmvn_rows(cmvn_pkl, feat_dim)  # alive past create
            c_mean, c_std = (x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                             for x in self._cmvn)
        self._init_handle(lib, lib.vox_feeder_create(
            (ctypes.c_char_p * n)(*paths), (ctypes.c_int64 * n)(*offsets),
            (ctypes.c_int32 * n)(*labels), n, feat_dim, feat_length, batch_size,
            num_accumulation_steps, resolve_num_workers(num_threads), seed,
            cmn_window if sliding_cmn else 0, skip_percent, int(wire_bf16), c_mean, c_std))

    def _alloc(self):
        shape = (self.a, self.b, self.t, self.f)
        feats = np.empty(shape, np.int16 if self.wire_bf16 else np.float32)
        labels = np.empty((self.a, self.b), np.int32)
        batch = (torch.from_numpy(feats).view(torch.bfloat16) if self.wire_bf16 else feats,
                 labels)
        return (feats.ctypes.data_as(ctypes.c_void_p),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))), batch


class NativeRawBatchFeeder(_NativeFeeder):
    """Raw-audio training feeder in C++ (``native/vox_raw.cc``): wav decode,
    augmentation-spec rendering (FFT reverb, SNR mixing), the int16 crop
    with CMN context and batch assembly in a thread pool, one ctypes call
    an optimizer step. The native counterpart of ``BatchFeeder`` over
    ``RawAudioShardDataset`` sources, with the JAX package's signature:
    ``get()`` returns ((waves (A, B, Smax) int16, num_samples, target_offset,
    pad_shift each (A, B) int32), labels (A, B) int32), the tuple
    ``ops/pipeline.py:waveform_to_features`` takes. Health as
    :class:`NativeBatchFeeder`'s."""

    _prefix = "vox_raw_feeder"
    _dead_hint = "bad wav paths or malformed specs?"

    def __init__(self, wav_scp, utt2id, feat_length: int, batch_size: int,
                 num_accumulation_steps: int = 1, *, cfg=None, context: int = 150,
                 num_threads: Optional[int] = None, seed: int = 0, skip_percent: int = 10,
                 shard_index: int = 0, num_shards: int = 1):
        from ..ops.fbank import FbankConfig
        from ..ops.pipeline import max_crop_samples
        from ..utils import datadir, resolve_num_workers

        self._handle = None
        lib = _lib_or_raise()
        cfg = cfg or FbankConfig()
        entries = list(datadir.read_two_column(wav_scp).items())[shard_index::num_shards]
        if not entries:
            raise ValueError(f"shard {shard_index} of {num_shards} of {wav_scp} is empty")
        n = len(entries)
        self.a, self.b = num_accumulation_steps, batch_size
        self.max_samples = max_crop_samples(feat_length, context, cfg)
        self._init_handle(lib, lib.vox_raw_feeder_create(
            (ctypes.c_char_p * n)(*(v.encode() for _, v in entries)),
            (ctypes.c_int32 * n)(*(int(utt2id[k]) if utt2id else 0 for k, _ in entries)),
            n, feat_length, context, cfg.frame_shift, cfg.frame_length, batch_size,
            num_accumulation_steps, resolve_num_workers(num_threads), seed, skip_percent))

    def _alloc(self):
        a, b = self.a, self.b
        waves = np.empty((a, b, self.max_samples), np.int16)
        ns, off, shift, labels = (np.empty((a, b), np.int32) for _ in range(4))
        as_i32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        return ((waves.ctypes.data_as(ctypes.c_void_p), as_i32(ns), as_i32(off),
                 as_i32(shift), as_i32(labels)),
                ((waves, ns, off, shift), labels))
