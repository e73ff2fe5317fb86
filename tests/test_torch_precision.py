"""PyTorch port: every CLI's ``main`` sets one float32 precision rule
(``set_float32_precision``) before it does anything else: cuDNN and cuBLAS
in full float32, no TF32 (PyTorch leaves cuDNN's TF32 on by default, which
would convolve a ``bf16=False`` model with a 10-bit mantissa on the card).

Each ``main`` runs as the CLI tests run it, with the TF32 flags switched on
first; it stops where it would pick its device (the CPU has no card here),
and the flags must then be off."""

import pytest
import torch

import voxsrc2020_speaker_verification_tpu_torch as port
from voxsrc2020_speaker_verification_tpu_torch.cli import evaluate as tevaluate
from voxsrc2020_speaker_verification_tpu_torch.cli import export as texport
from voxsrc2020_speaker_verification_tpu_torch.cli import extract as textract
from voxsrc2020_speaker_verification_tpu_torch.cli import import_checkpoint as timport
from voxsrc2020_speaker_verification_tpu_torch.cli import prepare_data as tprepare
from voxsrc2020_speaker_verification_tpu_torch.cli import score as tscore
from voxsrc2020_speaker_verification_tpu_torch.cli import serve as tserve
from voxsrc2020_speaker_verification_tpu_torch.cli import train as ttrain


class Stop(Exception):
    """Raised where a CLI would pick its device."""


def stop(*args, **kwargs):
    raise Stop


CLIS = {
    "train": (ttrain, ["--recipe", "res2net_vox2_dev_aug", "--synthetic"]),
    "extract": (textract, ["--artifact", "a", "--data-dir", "d", "--out", "o"]),
    "serve": (tserve, ["--artifact", "a"]),
    "export": (texport, ["--exp-dir", "e"]),
    "score": (tscore, ["--trials", "t", "--xvectors", "x"]),
    "evaluate": (tevaluate, ["--artifact", "a", "--trials", "T"]),
    "import_checkpoint": (timport, ["--ckpt", "c", "--model", "tdnn", "--exp-dir", "e"]),
    "prepare_data": (tprepare, ["--stage", "2", "--wav-root", "w"]),
}


@pytest.fixture
def tf32_on(monkeypatch):
    """TF32 on, as PyTorch leaves cuDNN, and the matmul precision lowered;
    all three restored after the test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(precision)


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_main_turns_tf32_off(cli, tf32_on, monkeypatch):
    module, argv = CLIS[cli]
    monkeypatch.setattr(port, "resolve_device", stop)
    monkeypatch.setattr(tserve, "make_server", stop)
    monkeypatch.setattr(textract, "extract_dataset", stop)
    monkeypatch.setattr(timport, "load_snapshot", stop)
    monkeypatch.setattr(tprepare, "create_dataset", stop)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(Stop):
        module.main(argv)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_precision_rule_leaves_bf16_and_the_cpu_alone(tf32_on):
    """The rule names float32 only: it changes no default dtype, and a bf16
    convolution on the CPU gives the same result before and after it."""
    x = torch.randn(2, 8, 9, 5).bfloat16()
    w = torch.randn(4, 8, 3, 3).bfloat16()
    before = torch.nn.functional.conv2d(x, w, padding=1)
    port.set_float32_precision()
    assert torch.get_default_dtype() == torch.float32
    assert torch.equal(torch.nn.functional.conv2d(x, w, padding=1), before)
