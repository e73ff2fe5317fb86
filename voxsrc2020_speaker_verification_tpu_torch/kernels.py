"""Build, load and count the port's hand-written CUDA kernels (``csrc/``).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The build
happens at first use, into ``_build/`` beside this file (listed in
``.gitignore``); a library's file name carries the hash of its source and of
``common.cuh``, so an edited source is rebuilt. Importing this module needs no
``nvcc`` and no GPU.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a non-zero code
and only then adds one to the kernel's launch count. The counts are what
``chip_smoke.py`` reads to show that the serving path went through the
kernels.
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
                 functions: Dict[str, Sequence[type]]):
        self.name = name
        self.source = source
        self.functions = dict(functions)
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self) -> str:
        h = hashlib.sha256()
        for path in (self.source_path, os.path.join(CSRC_DIR, "common.cuh")):
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

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Call C function ``fn`` on ``device``'s current stream (appended as
        the last argument); raise if the launch was refused."""
        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = getattr(lib, fn)(*args, stream)
        if code != 0:
            msg = lib.vsv_error_string(code).decode()
            raise KernelError(f"{self.name}.{fn}: CUDA error {code} ({msg})")
        with self._lock:
            self.launches += 1


FBANK = CudaKernel("fbank", "fbank.cu", {
    "fbank_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                  _P],
})
SPLIT_CONV = CudaKernel("split_conv", "split_conv.cu", {
    "split_group": [_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "split_group_mma": [_I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _F, _P],
})
BN_ACT = CudaKernel("bn_act", "bn_epilogue.cu", {
    "bn_act": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _I,
               _P],
})
STATS_POOL = CudaKernel("stats_pool", "stats_pool.cu", {
    "stats_pool": [_I, _P, _P, _P, _I, _I, _I, _I, _F, _P],
})
KERNELS = (FBANK, SPLIT_CONV, BN_ACT, STATS_POOL)


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


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


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
