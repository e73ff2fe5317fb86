"""Build, load and count the port's hand-written CUDA kernels (``csrc/``).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The build
happens at first use, into ``_build/`` beside this file (listed in
``.gitignore``); a library's file name carries the hash of its source and of
the shared headers (``*.cuh``), so an edited source is rebuilt. Importing
this module needs no ``nvcc`` and no GPU.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a non-zero code
and only then adds one to the kernel's launch count (and to the count of
that C function: a kernel with a forward and a backward entry counts each;
an entry whose C code picks between kernels by shape is counted by the path
its wrapper was told it takes, ``"<function>:<path>"``).
The counts are what ``chip_smoke.py`` reads to show that the serving,
training and evaluation paths went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Sequence

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class KernelError(RuntimeError):
    """A kernel failed to build, to launch, or ran on a tensor it does not take."""


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                      "built from source at first use")


class CudaKernel:
    """One ``csrc`` source: its library, its C functions and its launch count."""

    def __init__(self, name: str, source: str,
                 functions: Dict[str, Sequence[type]],
                 paths: Optional[Dict[str, Sequence[str]]] = None):
        self.name = name
        self.source = source
        self.functions = dict(functions)
        self.paths = dict(paths or {})
        self.launches = 0
        self.fn_launches = self.zero_counts()
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def zero_counts(self) -> Dict[str, int]:
        """One count per C function, or per path of a function with paths."""
        return {key: 0 for fn in self.functions
                for key in ([f"{fn}:{p}" for p in self.paths[fn]] if fn in self.paths else [fn])}

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self) -> str:
        h = hashlib.sha256()
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        for path in (self.source_path, *(os.path.join(CSRC_DIR, f) for f in headers)):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"{self.name}-{h.hexdigest()[:16]}.so")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library exists; the output
        goes to a temporary name that :meth:`finish_build` renames."""
        if os.path.exists(self.library_path()):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        tmp = proc.tmp_path  # type: ignore[attr-defined]
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelError(f"nvcc failed on {self.source}:\n{out}")
        os.replace(tmp, self.library_path())

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.library_path())
                for fn, argtypes in self.functions.items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                lib.vsv_error_string.argtypes = [ctypes.c_int]
                lib.vsv_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, fn: str, device: torch.device, *args, path: Optional[str] = None) -> None:
        """Call C function ``fn`` on ``device``'s current stream (appended as
        the last argument); raise if the launch was refused. ``path`` names
        the kernel the C function picks, for a function declared with paths."""
        key = fn if path is None else f"{fn}:{path}"
        if key not in self.fn_launches:
            raise KernelError(f"{self.name}.{fn}: no launch count {key!r}")
        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = getattr(lib, fn)(*args, stream)
        if code != 0:
            msg = lib.vsv_error_string(code).decode()
            raise KernelError(f"{self.name}.{fn}: CUDA error {code} ({msg})")
        with self._lock:
            self.launches += 1
            self.fn_launches[key] += 1


FBANK = CudaKernel("fbank", "fbank.cu", {
    "fbank_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _F, _P, _F, _P],
    "fbank_plan": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    # waves, a, b, mel_start, mel_off, mel_w, tile_cols, out, part, tickets; batch ..
    # use_log; floor; noise; dither; smem; stream
    "fbank_general_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _F, _P, _F, _I, _P],
}, paths={"fbank_f32": ("plain", "dither"), "fbank_general_f32": ("plain", "dither")})
SPLIT_CONV = CudaKernel("split_conv", "split_conv.cu", {
    "split_group": [_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "split_group_mma": [_I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "split_group_pipe": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _L, _I, _P],
    "split_chain_fused": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _L, _I,
                          _P],
    "split_group_wgmma": [_I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _F, _L, _I, _P],
})
# K3 and K5 count their launches by design (ops/nn.py:bn_act_plan,
# bn_train_plan): K3's 4-channel vectors, folded rows or single channels,
# K5's cluster design on rows or on folded rows, its head design (2-D
# calls) on 16-byte vector lanes or single-channel lanes
BN_ACT = CudaKernel("bn_act", "bn_epilogue.cu", {
    "bn_act": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _I,
               _I, _P],
}, paths={"bn_act": ("vec", "fold", "single")})
# K4 / K4b take their plan as a host int array (ops/nn.py:stats_pool_plan);
# a launch counts under its design
STATS_POOL = CudaKernel("stats_pool", "stats_pool.cu", {
    "stats_pool": [_I, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
}, paths={"stats_pool": ("ring", "column", "stream")})
STATS_POOL_BWD = CudaKernel("stats_pool_bwd", "stats_pool_bwd.cu", {
    "stats_pool_bwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
}, paths={"stats_pool_bwd": ("ring", "column", "stream")})
BN_TRAIN = CudaKernel("bn_train", "bn_train.cu", {
    "bn_train_fwd": [_I, _P, _P, _I, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                     _P, _P, _F, _F, _F, _F, _P, _P, _I, _P],
    "bn_train_bwd": [_I, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P, _P, _P, _I, _P],
    "bn_cluster_fwd": [_I, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _F, _F, _F, _F, _P, _P],
    "bn_cluster_bwd": [_I, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _L, _P, _P, _P, _P],
    # the head design (2-D calls): dtype, x, sc, mode, relu, rows, groups, C,
    # then the plan's v, cl, rl, slab (ops/nn.py:bn_head_plan)
    "bn_head_fwd": [_I, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _I] + [_P] * 8
                   + [_F] * 4 + [_P, _P],
    "bn_head_bwd": [_I, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _I] + [_P] * 6
                   + [_P],
    # the spanning mode's entries take the plan's ten scalars as a host int
    # array and its table as a device pointer (ops/nn.py:bn_span_plan)
    "bn_span_stats": [_I, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _P],
    "bn_span_normalize": [_I, _P, _P, _I, _I, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _F, _F, _F, _F, _P, _P],
    "bn_span_bwd_reduce": [_I, _P, _P, _P, _I, _I, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P],
    "bn_span_bwd_grad": [_I, _P, _P, _P, _I, _I, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P],
}, paths={"bn_cluster_fwd": ("row", "fold"), "bn_cluster_bwd": ("row", "fold"),
          "bn_head_fwd": ("vector", "single"), "bn_head_bwd": ("vector", "single")})
MARGIN_CE = CudaKernel("margin_ce", "margin_ce.cu", {
    "margin_ce_fwd": [_P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "margin_ce_bwd": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "margin_ce_partial_fwd": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "margin_ce_partial_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P],
    "margin_ce_plan": [_I, _I, ctypes.POINTER(_I)],
}, paths={fn: ("slab", "stream") for fn in ("margin_ce_fwd", "margin_ce_bwd",
                                            "margin_ce_partial_fwd", "margin_ce_partial_bwd")})
SLIDING_CMVN = CudaKernel("sliding_cmvn", "sliding_cmvn.cu", {
    "sliding_cmvn": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P],
})
ATT_POOL = CudaKernel("att_pool", "att_pool.cu", {
    "att_pool_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "att_pool_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
})
# K9 / K9b take their launch plan as a host int array (models/res2net.py:
# split_train_plan)
SPLIT_TRAIN = CudaKernel("split_train", "split_train.cu", {
    "split_train_fwd": [_I, _I] + [_P] * 13 + [_F] * 4 + [_I, _P],
    "split_train_finish": [_I] + [_P] * 4 + [_P],
    "split_train_bwd_stats": [_I, _I] + [_P] * 10 + [_I, _P],
    "split_train_bwd_grad": [_I, _I] + [_P] * 19 + [_I, _L, _P],
})
# K10 takes its launch plan as a host int array (models/res2net.py:
# stride2_plan); a launch counts under its design
SPLIT_STRIDE2 = CudaKernel("split_stride2", "split_stride2.cu", {
    "split_stride2": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _L, _P],
}, paths={"split_stride2": ("mma", "vec", "single")})
# K11 / K11b take their launch plan as a host int array (models/res2net.py:
# stride2_train_plan)
SPLIT_STRIDE2_TRAIN = CudaKernel("split_stride2_train", "split_stride2_train.cu", {
    "split_stride2_train_fwd": [_I] + [_P] * 9 + [_F] * 4 + [_L, _P],
    "split_stride2_train_finish": [_I] + [_P] * 6,
    "split_stride2_train_bwd_stats": [_I] + [_P] * 9,
    "split_stride2_train_bwd_grad": [_I] + [_P] * 11 + [_L, _P],
})
KERNELS = (FBANK, SPLIT_CONV, BN_ACT, STATS_POOL, STATS_POOL_BWD, BN_TRAIN,
           MARGIN_CE, SLIDING_CMVN, ATT_POOL, SPLIT_TRAIN, SPLIT_STRIDE2, SPLIT_STRIDE2_TRAIN)


def build_all(kernels: Sequence[CudaKernel] = KERNELS) -> float:
    """Build every kernel library at once (one nvcc per source, all started
    together), load them, and return the seconds it took."""
    t0 = time.perf_counter()
    procs = [(k, k.start_build()) for k in kernels]
    for k, proc in procs:
        k.finish_build(proc)
    for k in kernels:
        k.load()
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0
            k.fn_launches = k.zero_counts()


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def function_launch_counts() -> Dict[str, int]:
    """Launches per C entry point, keyed ``"<kernel>.<function>"`` (or
    ``"<kernel>.<function>:<path>"`` for an entry with paths)."""
    return {f"{k.name}.{fn}": n for k in KERNELS for fn, n in k.fn_launches.items()}


def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The persistent stride-2 kernels' (K10, K11) CTA counts: as many as fit the
# H100's 132 SMs at once. A constant, not num_sms: it keeps their plans, and
# so which positions each partial sum holds, a function of the shape alone,
# the same bits on every card
PLAN_SMS = 132


# (device, stream, name) -> a scratch tensor of stream_scratch
_STREAM_SCRATCH = {}


def stream_scratch(device: torch.device, name: str, numel: int, dtype: torch.dtype) -> torch.Tensor:
    """Scratch of at least ``numel`` elements named ``name`` on the current
    stream of ``device``, zero when made and kept between calls: a kernel's
    tickets (which every launch leaves zero) or its partials. Launches on
    one stream run in order, so each stream keeps one of each."""
    key = (device, torch.cuda.current_stream(device).cuda_stream, name)
    buf = _STREAM_SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = _STREAM_SCRATCH[key] = torch.zeros(max(numel, 1), dtype=dtype, device=device)
    return buf


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of a tensor for ctypes, or None (NULL)."""
    return None if t is None else t.data_ptr()


def dtype_code(dtype: torch.dtype) -> int:
    """The C side's dtype switch: 0 float32, 1 bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise KernelError(f"kernels take float32 or bfloat16, got {dtype}")


def check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int,
               memory_format=torch.contiguous_format) -> None:
    """Raise unless ``t`` is a CUDA tensor of one of ``dtypes`` with ``ndim``
    dims, contiguous in ``memory_format``."""
    if t.device.type != "cuda":
        raise KernelError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise KernelError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise KernelError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=memory_format):
        raise KernelError(f"{name}: tensor must be contiguous in {memory_format}")
