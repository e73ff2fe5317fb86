"""PyTorch/CUDA port of ``voxsrc2020_speaker_verification_tpu`` for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package beside this one is the reference and is imported nowhere
here. This package serves Res2Net embeddings and verification scores
(``eval/serving.py``, ``cli/serve.py``); its device work goes through four
hand-written CUDA kernels (``csrc/``, built at first use by ``kernels.py``).

Entry points run on the GPU unless the caller asks for the CPU: ``device=None``
means ``"cuda"``, and with no CUDA device they raise. On a CPU tensor every
kernel wrapper takes its plain PyTorch version instead, which is how the tests
run here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``. Raises if CUDA is asked for and absent; never
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this port runs on the GPU; pass device='cpu' "
            "to run the plain PyTorch path")
    return dev
