"""PyTorch/CUDA port of ``voxsrc2020_speaker_verification_tpu`` for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package beside this one is the reference and is imported nowhere
here. This package serves embeddings and verification scores
(``eval/serving.py``, ``cli/serve.py``), trains every encoder family on
features or raw audio, in one process or several (``training/``,
``cli/train.py``, ``cli/launch.py``), evaluates what it trained
(``cli/export.py``, ``cli/extract.py``, ``cli/score.py``,
``cli/evaluate.py``), imports the reference's TF checkpoints
(``cli/import_checkpoint.py``) and prepares data (``cli/prepare_data.py``);
its device work goes through hand-written CUDA kernels (``csrc/``, built at
first use by ``kernels.py``).

Entry points run on the GPU unless the caller asks for the CPU: ``device=None``
means ``"cuda"``, and with no CUDA device they raise. On a CPU tensor every
kernel wrapper takes its plain PyTorch version instead, which is how the tests
run here. Every CLI's ``main`` first sets one precision rule
(:func:`set_float32_precision`): float32 convolutions and matmuls in full
float32, never TF32.
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


def set_float32_precision() -> None:
    """The port's precision rule, set at the start of every entry point:
    float32 convolutions and matrix products run in full float32, as the JAX
    reference computes them. PyTorch leaves cuDNN's TF32 on by default, which
    would convolve a ``bf16=False`` model with a 10-bit mantissa; bfloat16
    work is unaffected (TF32 applies to float32 operands only)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
