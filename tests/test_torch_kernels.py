"""PyTorch port, CUDA kernels: each kernel against its plain PyTorch
version on a GPU (``cuda`` marker; they skip without one). This file imports
no JAX, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels.py -q -p no:cacheprovider --noconftest

Tolerances: float32 1e-4 (fbank 1e-3 abs in log-mel); bfloat16 kernels
against the float32 plain version on the same bf16 inputs 2e-2 (K3, K4) and
5e-2 relative to the output's largest magnitude (K2, a three-group chain).
"""

import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu_torch import kernels
from voxsrc2020_speaker_verification_tpu_torch.models.res2net import (
    split_chain, split_chain_reference)
from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as tfb
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as tops


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    """A wrapper counts a launch only where it launches its kernel: on CPU
    tensors it runs the plain version and every count stays put."""
    before = kernels.launch_counts()
    x = torch.randn(2, 16, 9, 5).contiguous(memory_format=torch.channels_last)
    m, v = torch.zeros(16), torch.ones(16)
    mask = torch.ones(2, 9)
    tfb.fbank(torch.randn(1, 4000) * 1000, tfb.FbankConfig(dither=0.0))
    tops.bn_act(x, m, v, relu=True, shortcut=x, mask=mask)
    tops.stats_pool(x, mask)
    split_chain(x, torch.randn(12, 4, 3, 3), [m[:4]] * 3, [v[:4]] * 3, mask)
    assert kernels.launch_counts() == before
    assert {k.name for k in kernels.KERNELS} == set(before)


def test_kernel_sources_and_library_names():
    """Every kernel has its source under csrc/, and its library name carries
    the source hash (an edited source is rebuilt)."""
    for k in kernels.KERNELS:
        with open(k.source_path) as f:
            src = f.read()
        assert "Replaces:" in src and "Bound on the card" in src, k.source
        for fn in k.functions:
            assert f'extern "C" int {fn}(' in src, (k.source, fn)
        assert k.library_path().startswith(kernels.BUILD_DIR)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernels run only there "
                    "(chip_smoke.py checks them at the serving shapes)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_fbank_kernel_matches_plain(cuda):
    cfg = tfb.FbankConfig(dither=0.0)
    w = torch.from_numpy(tfb.pcm16(np.random.RandomState(0).randn(3, 33333) * 3000)
                         .astype(np.float32)).to(cuda)
    torch.testing.assert_close(tfb.fbank(w, cfg), tfb.fbank_reference(w, cfg),
                               rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_act_and_stats_pool_kernels_match_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 24, 50, 10, generator=g, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    s = torch.randn(4, 24, 50, 10, generator=g, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    m, v = torch.randn(24, device=cuda) * 0.1, torch.rand(24, device=cuda) + 0.5
    mask = (torch.arange(50, device=cuda)[None] < torch.tensor([50, 20, 1, 33], device=cuda)[:, None]).float()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    kw = dict(relu=True, shortcut=s, shortcut_mean=m, shortcut_var=v, mask=mask)
    torch.testing.assert_close(tops.bn_act(x, m, v, **kw).float(),
                               tops.bn_act_reference(x, m, v, **kw).float(), **tol)
    torch.testing.assert_close(tops.stats_pool(x, mask).float(),
                               tops.stats_pool_reference(x, mask).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,width", [(torch.float32, 24), (torch.bfloat16, 24),
                                         (torch.bfloat16, 48), (torch.bfloat16, 12)])
def test_split_chain_kernel_matches_plain(cuda, dtype, width):
    """K2 (tensor-core variant for bf16 at widths of 8k, CUDA-core variant
    otherwise) against the plain chain in float32 on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 4 * width, 37, 11, generator=g, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn(3 * width, width, 3, 3, generator=g, device=cuda) / (9 * width) ** 0.5).to(dtype)
    means = [torch.randn(width, device=cuda) * 0.1 for _ in range(3)]
    var = [torch.rand(width, device=cuda) + 0.5 for _ in range(3)]
    mask = (torch.arange(37, device=cuda)[None] < torch.tensor([37, 20, 1], device=cuda)[:, None]).float()
    got = split_chain(x, w, means, var, mask).float()
    want = split_chain_reference(x.float(), w.float(), means, var, mask)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert (got - want).abs().max() <= tol * want.abs().max()
