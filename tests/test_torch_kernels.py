"""PyTorch port, CUDA kernels: each kernel against its plain PyTorch
version on a GPU (``cuda`` marker; they skip without one). This file imports
no JAX, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels.py -q -p no:cacheprovider --noconftest

Tolerances: float32 1e-4 (fbank 1e-3 abs in log-mel); bfloat16 kernels
against the float32 plain version on the same bf16 inputs 2e-2 (K3, K4) and
5e-2 relative to the output's largest magnitude (K2, a chain of three or
five groups; K10 under the same bound).
The training kernels (K4b, K5, K6) against the autograd of their plain
versions: float32 1e-4 relative to each output's largest magnitude; K5 in
bfloat16 against the plain version in bfloat16 on the same inputs, 2e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxsrc2020_speaker_verification_tpu_torch import kernels
from voxsrc2020_speaker_verification_tpu_torch.losses.projections import (
    margin_ce, margin_ce_plan, margin_ce_reference)
from voxsrc2020_speaker_verification_tpu_torch.models.res2net import (
    split_chain, split_chain_reference, split_chain_train, split_stride2,
    split_stride2_reference, split_stride2_train)
from voxsrc2020_speaker_verification_tpu_torch.ops import cmvn as tcmvn
from voxsrc2020_speaker_verification_tpu_torch.ops import fbank as tfb
from voxsrc2020_speaker_verification_tpu_torch.ops import nn as tops
from voxsrc2020_speaker_verification_tpu_torch.ops import pipeline as tpipe


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
    split_chain_train(x.clone().requires_grad_(True), torch.randn(12, 4, 3, 3),
                      [m[:4].clone() for _ in range(3)], [v[:4].clone() for _ in range(3)], 2,
                      mask).sum().backward()
    xg = x.clone().requires_grad_(True)
    y = tops.bn_train(xg, m.clone(), v.clone(), groups=2, relu=True, shortcut=x,
                      shortcut_running_mean=m.clone(), shortcut_running_var=v.clone())
    (y.sum() + tops.stats_pool(xg).sum()).backward()
    cos = torch.rand(2, 3, 7, requires_grad=True)
    margin_ce(cos, torch.tensor([0, 3, 6]), 32.0, 0.2)[0].sum().backward()
    tcmvn.sliding_cmvn(torch.randn(2, 40, 5), torch.tensor([40, 17]), window=9, norm_vars=True)
    tpipe.waveform_to_features(torch.zeros(2, 4000, dtype=torch.int16), torch.tensor([4000, 900]),
                               torch.tensor([2, 0]), torch.tensor([0, 3]), tfb.FbankConfig(),
                               8, window=9, noise=torch.randn(2, 23, 400))
    xa = x.clone().requires_grad_(True)
    tops.att_pool(xa, x * 0.5, mask).sum().backward()
    x10 = torch.randn(2, 10, 9, 5).contiguous(memory_format=torch.channels_last)
    tops.bn_act(x10, torch.zeros(10), torch.ones(10), relu=True, mask=mask)
    tops.bn_train(x10.requires_grad_(True), torch.zeros(10), torch.ones(10), relu=True).sum().backward()
    x24 = torch.randn(2, 24, 9, 5).contiguous(memory_format=torch.channels_last)
    split_stride2(x24, torch.randn(18, 6, 3, 3), [torch.zeros(6)] * 3, [torch.ones(6)] * 3)
    split_stride2_train(x24.clone().requires_grad_(True), torch.randn(18, 6, 3, 3),
                        [torch.zeros(6) for _ in range(3)], [torch.ones(6) for _ in range(3)],
                        2).sum().backward()
    assert kernels.launch_counts() == before
    assert {k.name for k in kernels.KERNELS} == set(before)


def test_split_stride2_routes_on_the_cpu():
    """The stride-2 stage's route counter: "plain" for a CPU tensor in eval
    (the wrapper's plain version), "train_plain" in training (the training
    wrapper's plain version, which K11 / K11b replace on the card); never
    "kernel", "train_kernels" or "span" here."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    stage = rn.Res2NetSplitConv(4, 6, 2)
    torch.nn.init.normal_(stage.weight, 0, 0.1)
    x = torch.randn(4, 24, 11, 7).contiguous(memory_format=torch.channels_last)
    before = rn.split_stride2_route_counts()
    with torch.no_grad():
        y = stage(x, False)
    after = rn.split_stride2_route_counts()
    assert {k: after[k] - before[k] for k in after} == {"kernel": 0, "plain": 1,
                                                        "train_kernels": 0, "train_plain": 0,
                                                        "span": 0}
    want = split_stride2_reference(x, stage.weight, [bn.running_mean for bn in stage._bns()],
                                   [bn.running_var for bn in stage._bns()])
    assert torch.equal(y, want) and y.shape == (4, 24, 6, 4)
    stage(x.requires_grad_(True), True).sum().backward()
    last = rn.split_stride2_route_counts()
    assert {k: last[k] - after[k] for k in last} == {"kernel": 0, "plain": 0, "train_kernels": 0,
                                                     "train_plain": 1, "span": 0}
    assert x.grad is not None and stage.weight.grad is not None


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


@pytest.mark.parametrize("num_bins", [40, 80, 128])
def test_fbank_mel_columns_rebuild_the_mel_matrix(num_bins):
    """K1 reads M by columns: each column's run from its first to its last
    nonzero, packed in column order. The runs rebuild M exactly."""
    m = tfb.analysis_matrices(tfb.FbankConfig(num_bins=num_bins))[2]
    starts, offsets, weights = tfb.mel_columns(m)
    assert starts.shape == (num_bins,) and offsets.shape == (num_bins + 1,)
    assert offsets[-1] == weights.size
    rebuilt = np.zeros_like(m)
    for c in range(num_bins):
        run = weights[offsets[c]:offsets[c + 1]]
        rebuilt[starts[c]:starts[c] + run.size, c] = run
    np.testing.assert_array_equal(rebuilt, m)
    # an all-zero column has an empty run
    starts, offsets, _ = tfb.mel_columns(np.zeros((8, 2), np.float32))
    assert list(offsets) == [0, 0, 0]


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
@pytest.mark.parametrize("dtype,width,t,f,split", [
    (torch.float32, 24, 37, 11, 4), (torch.bfloat16, 24, 37, 11, 4),
    (torch.bfloat16, 48, 37, 11, 4), (torch.bfloat16, 12, 37, 11, 4),
    (torch.bfloat16, 96, 37, 11, 4), (torch.bfloat16, 192, 37, 11, 4),
    (torch.bfloat16, 24, 53, 80, 4), (torch.bfloat16, 96, 41, 20, 4),
    (torch.bfloat16, 192, 125, 10, 4), (torch.bfloat16, 8, 37, 11, 6),
    (torch.bfloat16, 16, 41, 20, 6), (torch.bfloat16, 32, 23, 10, 6),
    (torch.bfloat16, 40, 37, 11, 4)])
def test_split_chain_kernel_matches_plain(cuda, dtype, width, t, f, split):
    """K2 against the plain chain in float32 on the same inputs, with masks
    and ragged patch tails: the fused chain (bf16, w = 24 at split 4, w = 8
    and 16 at split 6: one launch), the pipelined variant (w = 48; w = 32 at
    split 6), the warpgroup-MMA variant (w = 96, 192), the first tensor-core
    variant (w = 40) and the CUDA-core variant (float32, w = 12), each
    launched as split_plan names it."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import split_plan

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, split * width, t, f, generator=g, device=cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn((split - 1) * width, width, 3, 3, generator=g, device=cuda)
         / (9 * width) ** 0.5).to(dtype)
    means = [torch.randn(width, device=cuda) * 0.1 for _ in range(split - 1)]
    var = [torch.rand(width, device=cuda) + 0.5 for _ in range(split - 1)]
    mask = (torch.arange(t, device=cuda)[None] < torch.tensor([t, 20, 1], device=cuda)[:, None]).float()
    before = dict(kernels.SPLIT_CONV.fn_launches)
    got = split_chain(x, w, means, var, mask).float()
    want = split_chain_reference(x.float(), w.float(), means, var, mask)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert (got - want).abs().max() <= tol * want.abs().max()
    variant = split_plan(width, t, f, dtype, split)["variant"]
    fn = {"fused": "split_chain_fused", "pipe": "split_group_pipe", "mma": "split_group_mma",
          "wgmma": "split_group_wgmma", "fma": "split_group"}[variant]
    assert kernels.SPLIT_CONV.fn_launches[fn] - before[fn] == (
        1 if variant == "fused" else split - 1)
    if dtype == torch.bfloat16 and width in (8, 16, 24, 32, 48):
        assert variant == ("fused" if width * split <= 96 else "pipe")
    if dtype == torch.bfloat16 and width in (96, 192):
        assert variant == "wgmma"
    if width == 40:
        assert variant == "mma"


# K2's warpgroup-MMA variant at the serving stages and its edges: (batch,
# width, T, F, split, lengths) with lengths None for no mask and 0 for a row
# masked throughout
WGMMA_CASES = [
    (2, 96, 250, 20, 4, (250, 177)),      # res2net50_w24's stage 3 at 1000 frames
    (2, 192, 125, 10, 4, (125, 64)),      # its stage 4
    (3, 96, 41, 13, 4, (41, 20, 7)),      # a ragged F: one 13-wide tile
    (3, 192, 1, 10, 4, (1, 1, 1)),        # T = 1
    (1, 192, 40, 10, 4, None),            # B = 1, no mask
    (3, 96, 30, 20, 4, (30, 12, 0)),      # a row masked throughout
    (2, 64, 125, 10, 6, (125, 90)),       # res2net50_w8_s6_c16's stage 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,width,t,f,split,lengths", WGMMA_CASES)
def test_split_chain_wgmma_matches_plain(cuda, b, width, t, f, split, lengths):
    """K2's warpgroup-MMA variant against the plain chain in float32 on the
    same bf16 inputs (5e-2 relative to the output's largest magnitude, as
    the other bf16 variants: a chain of three or five groups): one launch a
    group, reruns bit for bit, finite, and the pass-through group equal to
    its input."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import split_plan

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(b, split * width, t, f, generator=g, device=cuda)
    mask = None
    if lengths is not None:
        mask = (torch.arange(t, device=cuda)[None] < torch.tensor(lengths, device=cuda)[:, None]).float()
        x = x * mask[:, None, :, None]
    x = x.bfloat16().contiguous(memory_format=torch.channels_last)
    w = (torch.randn((split - 1) * width, width, 3, 3, generator=g, device=cuda)
         / (9 * width) ** 0.5).bfloat16()
    means = [torch.randn(width, device=cuda) * 0.1 for _ in range(split - 1)]
    var = [torch.rand(width, device=cuda) + 0.5 for _ in range(split - 1)]
    assert split_plan(width, t, f, torch.bfloat16, split)["variant"] == "wgmma"
    before = kernels.SPLIT_CONV.fn_launches["split_group_wgmma"]
    got = split_chain(x, w, means, var, mask)
    assert kernels.SPLIT_CONV.fn_launches["split_group_wgmma"] - before == split - 1
    want = split_chain_reference(x.float(), w.float(), means, var, mask)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max() <= 5e-2 * want.abs().max()
    assert torch.equal(got[:, (split - 1) * width:], x[:, (split - 1) * width:])
    assert torch.equal(got, split_chain(x, w, means, var, mask))


# K10, the stride-2 split stage in eval: (dtype, batch, width, split, T, F,
# lengths): the serving model's three stages at a thinner batch (and its
# stage 4 at the full (128, 768, 250, 20)), the bench model's (s = 6), the
# thin variants' w = 8 and w = 5 (the single-channel design), odd and even
# T and F, and inputs with zeroed (masked) rows (lengths, 0 a row masked
# throughout)
STRIDE2_CASES = [
    (torch.bfloat16, 4, 48, 4, 1000, 80, (1000, 613, 0, 1000)),
    (torch.float32, 2, 48, 4, 1000, 80, (1000, 517)),
    (torch.bfloat16, 4, 96, 4, 500, 40, (500, 201, 500, 9)),
    (torch.float32, 2, 96, 4, 101, 40, None),
    (torch.bfloat16, 128, 192, 4, 250, 20, None),
    (torch.float32, 2, 192, 4, 49, 19, (49, 30)),
    (torch.bfloat16, 3, 16, 6, 999, 79, (999, 500, 1)),
    (torch.bfloat16, 3, 32, 6, 250, 40, None),
    (torch.bfloat16, 3, 64, 6, 125, 20, (125, 0, 77)),
    (torch.bfloat16, 3, 8, 4, 17, 9, (17, 5, 0)),
    (torch.bfloat16, 2, 8, 6, 20, 11, None),
    (torch.float32, 3, 8, 6, 21, 10, (21, 13, 2)),
    (torch.bfloat16, 3, 5, 4, 17, 9, (17, 8, 3)),
    (torch.float32, 2, 5, 4, 18, 10, None),
    (torch.bfloat16, 2, 56, 4, 33, 20, (33, 12)),
    (torch.bfloat16, 2, 48, 4, 1, 1, None),
    (torch.bfloat16, 1, 96, 4, 2, 3, None),
]


def stride2_case(cuda, dtype, b, width, split, t, f, lengths, seed=9):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, split * width, t, f, generator=g, device=cuda)
    if lengths is not None:
        mask = (torch.arange(t, device=cuda)[None] < torch.tensor(lengths, device=cuda)[:, None])
        x = x * mask[:, None, :, None]
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    w = (torch.randn((split - 1) * width, width, 3, 3, generator=g, device=cuda)
         / (9 * width) ** 0.5).to(dtype)
    means = [torch.randn(width, generator=g, device=cuda) * 0.1 for _ in range(split - 1)]
    var = [torch.rand(width, generator=g, device=cuda) + 0.5 for _ in range(split - 1)]
    return x, w, means, var


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,width,split,t,f,lengths", STRIDE2_CASES, ids=str)
def test_split_stride2_kernel_matches_plain(cuda, dtype, b, width, split, t, f, lengths):
    """K10 against its plain version in float32 on the same inputs: float32
    within 1e-4, bfloat16 within 5e-2 (the split_conv bound), relative to
    the output's largest magnitude; the average-pool channels bit-equal to
    the plain version run in the kernel's dtype on the card; one launch on
    the design the plan names; reruns bit for bit."""
    from voxsrc2020_speaker_verification_tpu_torch.models.res2net import stride2_plan

    x, w, means, var = stride2_case(cuda, dtype, b, width, split, t, f, lengths)
    design = stride2_plan(width, split, tuple(x.shape), dtype)["design"]
    key = f"split_stride2:{design}"
    before = kernels.SPLIT_STRIDE2.fn_launches[key]
    got = split_stride2(x, w, means, var)
    assert kernels.SPLIT_STRIDE2.fn_launches[key] - before == 1
    assert got.shape == (b, split * width, (t - 1) // 2 + 1, (f - 1) // 2 + 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = split_stride2_reference(x.float(), w.float(), means, var)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max() <= tol * want.abs().max()
    tail = slice((split - 1) * width, None)
    assert torch.equal(got[:, tail], split_stride2_reference(x, w, means, var)[:, tail])
    assert torch.equal(got, split_stride2(x, w, means, var))
    if dtype == torch.bfloat16 and width % 8 == 0 and width != 56:
        assert design == "mma"
    elif width % (16 // x.element_size()) == 0:
        assert design == "vec"
    else:
        assert design == "single"


@pytest.mark.cuda
@pytest.mark.parametrize("width,split,t,f", [(48, 4, 37, 80), (96, 4, 51, 40), (192, 4, 61, 20),
                                             (64, 6, 50, 19), (32, 6, 27, 40), (16, 6, 9, 80),
                                             (8, 4, 17, 9)])
def test_split_stride2_every_mma_plan_matches_plain(cuda, width, split, t, f):
    """Every mma plan K10 can take at a width (stride2_candidates: the
    width's kernel, the largest tile at one and at two CTAs an SM), on a
    grid whose tiles are those of the serving stage: within 5e-2 of the
    plain version in float32, the average pool bit-equal to it in bf16, and
    the plans (one kernel, so one K order) bit-equal."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    x, w, means, var = stride2_case(cuda, torch.bfloat16, 3, width, split, t, f, (t, t // 2, 1))
    want = split_stride2_reference(x.float(), w.float(), means, var)
    tail = slice((split - 1) * width, None)
    want_tail = split_stride2_reference(x, w, means, var)[:, tail]
    plans = rn.stride2_candidates(width, split, tuple(x.shape))
    assert plans
    outs = []
    for plan in plans:
        out = torch.empty_like(want, dtype=x.dtype).contiguous(memory_format=torch.channels_last)
        rn._stride2_launch(x, w, means, var, 1e-5, plan, out)
        assert (out.float() - want).abs().max() <= 5e-2 * want.abs().max(), plan
        assert torch.equal(out[:, tail], want_tail), plan
        outs.append(out)
        assert torch.equal(out, outs[0]), plan


@pytest.mark.cuda
def test_split_stride2_unaligned_input_takes_the_single_design(cuda):
    """An input that does not start on a 16-byte boundary takes the
    single-element design, with the same results as the aligned input."""
    x, w, means, var = stride2_case(cuda, torch.bfloat16, 2, 48, 4, 37, 21, None)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xu = buf[1:].view(2, 37, 21, 192).permute(0, 3, 1, 2)
    xu.copy_(x)
    before = kernels.SPLIT_STRIDE2.fn_launches["split_stride2:single"]
    got = split_stride2(xu, w, means, var)
    assert kernels.SPLIT_STRIDE2.fn_launches["split_stride2:single"] - before == 1
    want = split_stride2_reference(x.float(), w.float(), means, var)
    assert (got.float() - want).abs().max() <= 5e-2 * want.abs().max()


@pytest.mark.cuda
def test_split_stride2_stage_in_eval_launches_k10_alone(cuda, monkeypatch):
    """Res2NetSplitConv(strides=2) in eval on a CUDA tensor: one K10 launch
    and nothing of the route it replaced (no F.conv2d, K3, average pool or
    torch.cat), route "kernel"; on the card the call's device kernels are
    K10's and the cast of the model's float32 weight to x's dtype, nothing
    else (no copy of the weight into another layout); in training K11 /
    K11b, counted "train_kernels", and no K10."""
    from torch.profiler import ProfilerActivity, profile

    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    stage = rn.Res2NetSplitConv(4, 48, 2).to(cuda)
    with torch.no_grad():
        stage.weight.normal_(0, 0.05)
    x, _, _, _ = stride2_case(cuda, torch.bfloat16, 2, 48, 4, 40, 20, (40, 17))
    want = rn.split_stride2_reference(x, stage.weight.bfloat16(),
                                      [bn.running_mean for bn in stage._bns()],
                                      [bn.running_var for bn in stage._bns()])

    def refuse(*a, **k):
        raise AssertionError("the eval stage ran a step of the replaced route")

    with torch.inference_mode():
        stage(x, False)  # the kernels built and loaded before the profile
    torch.cuda.synchronize()
    before = (kernels.launch_counts(), rn.split_stride2_route_counts())
    with monkeypatch.context() as m, profile(activities=[ProfilerActivity.CUDA]) as prof:
        for mod, name in ((rn.F, "conv2d"), (rn.ops, "avg_pool_3x3"), (rn.ops, "bn_act"),
                          (rn.ops, "fixed_padding"), (torch, "cat")):
            m.setattr(mod, name, refuse)
        with torch.inference_mode():
            stage.weight.to(x.dtype)  # the weight's cast alone, to name its kernel
            got = stage(x, False)
        torch.cuda.synchronize()
    ran = sorted((e.key, e.count) for e in prof.key_averages() if e.device_type.name == "CUDA")
    # K10 once, the cast twice (the one above and the stage's), nothing else
    k10 = [k for k, _ in ran if "stride2_" in k]
    assert len(k10) == 1 and len(ran) == 2 and (k10[0], 1) in ran, ran
    assert [n for k, n in ran if k != k10[0]] == [2], ran
    counts, routes = kernels.launch_counts(), rn.split_stride2_route_counts()
    assert counts["split_stride2"] - before[0]["split_stride2"] == 1
    assert counts["bn_act"] == before[0]["bn_act"]
    assert routes["kernel"] - before[1]["kernel"] == 1
    assert (got.float() - want.float()).abs().max() <= 5e-2 * want.float().abs().max()
    stage.train()
    got = stage(x.float().requires_grad_(True), True)
    got.sum().backward()
    assert kernels.launch_counts()["split_stride2"] == counts["split_stride2"]
    assert kernels.launch_counts()["split_stride2_train"] - counts["split_stride2_train"] == 4
    assert rn.split_stride2_route_counts()["train_kernels"] - routes["train_kernels"] == 1


@pytest.mark.cuda
def test_split_stride2_refuses_a_plan_of_another_layout(cuda, monkeypatch):
    """K10's mma design checks the plan's shared-memory size against its own
    layout's: a plan copied wrong is refused, never launched."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    x, w, means, var = stride2_case(cuda, torch.bfloat16, 2, 96, 4, 23, 19, None)
    split_stride2(x, w, means, var)
    size = rn._stride2_smem
    monkeypatch.setattr(rn, "_stride2_smem", lambda *a: size(*a) - 16)
    rn.stride2_plan.cache_clear()
    try:
        with pytest.raises(kernels.KernelError, match="plan"):
            split_stride2(x, w, means, var)
    finally:
        monkeypatch.undo()
        rn.stride2_plan.cache_clear()


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-12))


def bn_case(cuda, shape, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=cuda) * 1.5 + 0.3).to(dtype)
    if x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    stats = [torch.randn(c, device=cuda) * 0.1, torch.rand(c, device=cuda) + 0.5]
    return x, stats


# Relu decisions in which K5 and its plain version differ, at most, on the
# inputs below (H100: one, float32 with a normalized shortcut, groups 8): at
# the largest shape a pre-relu value within rounding of zero may fall on
# either side, since the two sum the moments in other orders, and one such
# element moves dx there by |dy| * rstd. Every other shape is compared at
# every element.
RELU_FLIPS = {(64, 16, 200, 80): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((16, 24, 9, 5), 1), ((16, 24, 9, 5), 8),
                                          ((64, 40), 1), ((64, 40), 8),
                                          ((32, 64, 25, 10), 8), ((64, 16, 200, 80), 8),
                                          ((64, 16, 200, 80), 1)])
@pytest.mark.parametrize("mode", ["plain", "relu", "raw_shortcut", "bn_shortcut"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_kernel_matches_plain(cuda, shape, groups, mode, dtype):
    """K5 forward (output, both running updates) and backward (x and
    shortcut gradients) against autograd of the plain version: the cluster
    design on 4-D inputs (with one cluster a group and with several behind
    the group barrier; slabs kept in shared memory and streamed twice), the
    head design on 2-D ones."""
    x, (rm, rv) = bn_case(cuda, shape, dtype, 3)
    s, (srm, srv) = bn_case(cuda, shape, dtype, 4)
    dy = bn_case(cuda, shape, dtype, 5)[0]
    outs = []
    for fn in (tops.bn_train, tops.bn_train_reference):
        xi, si = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
        st = [t.clone() for t in (rm, rv, srm, srv)]
        kw = dict(groups=groups, relu=mode != "plain")
        if mode != "plain" and mode != "relu":
            kw["shortcut"] = si
        if mode == "bn_shortcut":
            kw.update(shortcut_running_mean=st[2], shortcut_running_var=st[3])
        y = fn(xi, st[0], st[1], **kw)
        y.backward(dy)
        outs.append((y.detach(), xi.grad, si.grad, st))
    (y, dx, ds, st), (yr, dxr, dsr, str_) = outs
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    # gradients where both versions take the same relu decision (RELU_FLIPS)
    flips = RELU_FLIPS.get(shape, 0) if mode != "plain" else 0
    same = (y > 0) == (yr > 0) if flips else torch.ones_like(y, dtype=torch.bool)
    assert int((~same).sum()) <= flips
    assert rel(y, yr) <= tol and rel(dx * same, dxr * same) <= tol
    if mode in ("raw_shortcut", "bn_shortcut"):
        assert rel(ds * same, dsr * same) <= tol
    for a, b in zip(st, str_):
        assert rel(a, b) <= 1e-4


def pool_case(cuda, shape, mask_kind, dtype, misaligned=False, seed=6):
    """x (B, C, T, F) in channels-last memory, a (B, T) mask and dout. The
    masks: "lengths" (rows of T, T/3, 1 and 0 valid frames), "interior"
    (random zeros inside the rows, row 1 fully masked), "weights" (uniform
    in [0, 1)). `misaligned`: x starts one element past a 16-byte boundary."""
    b, c, t, f = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(b, t, f, c, generator=g, device=cuda) * 2 + 1).to(dtype)
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(x.flatten())
        x = buf[1:].view(b, t, f, c)
    x = x.permute(0, 3, 1, 2)
    mask = None
    if mask_kind == "lengths":
        lens = torch.tensor([t, t // 3, 1, 0], device=cuda).repeat(b)[:b]
        mask = (torch.arange(t, device=cuda)[None] < lens[:, None]).float()
    elif mask_kind == "interior":
        mask = (torch.rand(b, t, generator=g, device=cuda) > 0.3).float()
        mask[1] = 0.0
    elif mask_kind == "weights":
        mask = torch.rand(b, t, generator=g, device=cuda)
    dout = torch.randn(b, 2 * c, 1, f, generator=g, device=cuda).to(dtype)
    return x, mask, dout


def pool_run(fn, x, mask, dout):
    """(output, input gradient) of the stats pool ``fn``."""
    xi = x.detach().requires_grad_(True)  # a view: keeps x's alignment
    y = fn(xi, mask)
    y.backward(dout)
    return y.detach(), xi.grad


# (B, C, T, F), mask, dtype, x misaligned: the serving head's tile and T
# (masked, bf16), the training head's (unmasked), T past the ring (the column
# design), ragged C (20; 300 = two full fp32 tiles and a ragged third),
# interior zeros with a fully masked row, weights, a misaligned x; W = 1 at
# the TDNN and ECAPA heads' T (200, 320) and extraction's (1000, 1024), on
# 128-, 64- and 32-byte tile rows, one misaligned with a ragged tile, one
# whose rows are no multiple of 16 bytes (both staged by cp.async instead of
# tensor copies), and one past the on-chip columns (T = 4000: the stream
# design)
POOL_CASES = [
    ((2, 256, 200, 1), None, torch.bfloat16, False),
    ((2, 256, 200, 1), "lengths", torch.float32, False),
    ((2, 192, 320, 1), "interior", torch.bfloat16, False),
    ((2, 96, 320, 1), None, torch.float32, False),
    ((4, 128, 1000, 1), "lengths", torch.bfloat16, False),
    ((2, 72, 1000, 1), "weights", torch.float32, False),
    ((4, 64, 1024, 1), "lengths", torch.float32, False),
    ((2, 40, 1024, 1), None, torch.bfloat16, True),
    ((3, 96, 600, 1), "interior", torch.float32, False),
    ((2, 20, 300, 1), "weights", torch.bfloat16, False),
    ((2, 64, 4000, 1), "lengths", torch.bfloat16, False),
    ((4, 32, 25, 10), None, torch.float32, False),
    ((4, 32, 25, 10), "lengths", torch.float32, False),
    ((3, 256, 125, 10), "lengths", torch.bfloat16, False),
    ((3, 256, 125, 10), "interior", torch.float32, False),
    ((4, 512, 25, 10), None, torch.bfloat16, False),
    ((2, 64, 1200, 3), "lengths", torch.float32, False),
    ((2, 64, 1200, 3), "interior", torch.bfloat16, False),
    ((3, 20, 37, 5), "interior", torch.float32, False),
    ((3, 20, 37, 5), "weights", torch.bfloat16, False),
    ((2, 300, 50, 4), "interior", torch.float32, False),
    ((2, 264, 50, 4), "lengths", torch.bfloat16, False),
    ((2, 64, 30, 3), "lengths", torch.float32, True),
    ((2, 64, 30, 3), "weights", torch.bfloat16, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mask_kind,dtype,misaligned", POOL_CASES)
def test_stats_pool_backward_kernel_matches_plain(cuda, shape, mask_kind, dtype, misaligned):
    """K4 (output) and K4b (input gradient) against the plain version and
    its autograd on the same inputs, one launch each: float32 within 1e-4,
    bfloat16 within 2e-2 of each output's largest magnitude."""
    x, mask, dout = pool_case(cuda, shape, mask_kind, dtype, misaligned)
    assert (x.data_ptr() % 16 != 0) == misaligned
    b, c, t, f = shape
    design = tops.stats_pool_plan(b, t, f, c, dtype)["design"]
    keys = (f"stats_pool.stats_pool:{design}", f"stats_pool_bwd.stats_pool_bwd:{design}")
    before = (kernels.STATS_POOL.launches, kernels.STATS_POOL_BWD.launches)
    by_path = kernels.function_launch_counts()
    y, dx = pool_run(tops.stats_pool, x, mask, dout)
    assert (kernels.STATS_POOL.launches - before[0], kernels.STATS_POOL_BWD.launches - before[1]) == (1, 1)
    after = kernels.function_launch_counts()
    assert [after[k] - by_path[k] for k in keys] == [1, 1]
    yr, dxr = pool_run(tops.stats_pool_reference, x, mask, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert y.dtype == dx.dtype == dtype
    assert rel(y, yr) <= tol and rel(dx, dxr) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mask_kind", [((3, 256, 125, 10), "lengths"),
                                             ((4, 512, 25, 10), None),
                                             ((2, 64, 1200, 3), "interior"),
                                             ((8, 1536, 320, 1), "lengths")])
def test_stats_pool_kernels_rerun_bit_for_bit(cuda, shape, mask_kind):
    """Two runs of K4 and K4b on the same inputs agree bit for bit (each
    lane adds its rows in time order, the warps' sums in warp order)."""
    x, mask, dout = pool_case(cuda, shape, mask_kind, torch.bfloat16)
    a, b = (pool_run(tops.stats_pool, x, mask, dout) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_stats_pool_kernel_multiplies_masked_rows(cuda):
    """A masked row is multiplied by its 0, as the plain version does, not
    skipped: an inf there makes the same NaNs in the output."""
    x, mask, _ = pool_case(cuda, (4, 32, 25, 10), "lengths", torch.float32)
    x = x.clone()
    x[1, :5, 20] = float("inf")  # row 1 holds 8 valid frames
    got, want = tops.stats_pool(x, mask), tops.stats_pool_reference(x, mask)
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, equal_nan=True)


@pytest.mark.cuda
def test_margin_ce_kernel_matches_plain(cuda):
    """K6 loss, correct flags and dcos_all (ties between centers split
    evenly) against autograd of the plain version, |cos| < 0.999."""
    g = torch.Generator(device=cuda).manual_seed(7)
    cos = (torch.rand(2, 37, 1001, generator=g, device=cuda) * 2 - 1) * 0.998
    cos[1, :, :50] = cos[0, :, :50]
    labels = torch.randint(0, 1001, (37,), generator=g, device=cuda)
    outs = []
    for fn in (margin_ce, margin_ce_reference):
        ci = cos.clone().requires_grad_(True)
        loss, correct = fn(ci, labels, 32.0, 0.2)
        (loss * torch.linspace(0.5, 1.5, 37, device=cuda)).sum().backward()
        outs.append((loss.detach(), correct, ci.grad))
    (l, c, d), (lr_, cr, dr) = outs
    assert rel(l, lr_) <= 1e-4 and torch.equal(c, cr) and rel(d, dr) <= 1e-4


def bn_run(cuda, shape, groups, mode, dtype):
    """One K5 forward and backward under relu: ([y, dx, (ds,) running
    statistics], the tensors autograd saved for the backward)."""
    x, s, dy = (bn_case(cuda, shape, dtype, seed)[0] for seed in (3, 4, 5))
    g = torch.Generator(device=cuda).manual_seed(6)
    rm, srm = (torch.randn(shape[1], generator=g, device=cuda) * 0.1 for _ in range(2))
    rv, srv = (torch.rand(shape[1], generator=g, device=cuda) + 0.5 for _ in range(2))
    xi, si = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    kw = dict(groups=groups, relu=True)
    if mode:
        kw["shortcut"] = si
    if mode == 2:
        kw.update(shortcut_running_mean=srm, shortcut_running_var=srv)
    y = tops.bn_train(xi, rm, rv, **kw)
    saved = [t for t in y.grad_fn.saved_tensors if t is not None]
    y.backward(dy)
    return [y.detach(), xi.grad] + ([si.grad] if mode else []) + [rm, rv, srm, srv], saved


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((32, 64, 25, 10), 8), ((64, 16, 200, 80), 8),
                                          ((64, 16, 200, 80), 1), ((64, 40), 8)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bn_train_kernel_reruns_bit_for_bit(cuda, shape, groups, mode):
    """Two K5 runs on the same inputs agree bit for bit: outputs, gradients
    and running statistics (no float atomics; the cluster design's sums
    across CTAs, clusters and groups are added in a fixed order)."""
    a, _ = bn_run(cuda, shape, groups, mode, torch.bfloat16)
    b, _ = bn_run(cuda, shape, groups, mode, torch.bfloat16)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bn_train_cluster_saves_no_output(cuda, mode):
    """The cluster design recomputes the relu decision from x (and a
    normalized shortcut), so autograd keeps the forward output only for a
    raw shortcut; each direction is one launch."""
    before = dict(kernels.BN_TRAIN.fn_launches)
    outs, saved = bn_run(cuda, (32, 64, 25, 10), 8, mode, torch.bfloat16)
    after = kernels.BN_TRAIN.fn_launches
    assert after["bn_cluster_fwd:row"] - before["bn_cluster_fwd:row"] == 1
    assert after["bn_cluster_bwd:row"] - before["bn_cluster_bwd:row"] == 1
    y = outs[0]
    holds_y = any(t.data_ptr() == y.data_ptr() for t in saved)
    assert holds_y == (mode == 1)


@pytest.mark.cuda
def test_bn_train_cluster_on_two_streams(cuda):
    """Two K5 cluster launches in flight at once on two streams (each its
    own sync words and scratch; a cooperative launch starts its grid only
    when every CTA can be resident) give what they give one after the
    other, bit for bit."""
    cases = [((64, 16, 200, 80), 8, 2), ((64, 16, 200, 80), 8, 0)]
    want = [bn_run(cuda, shape, groups, mode, torch.bfloat16)[0] for shape, groups, mode in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    got = []
    for stream, (shape, groups, mode) in zip(streams, cases):
        with torch.cuda.stream(stream):
            got.append(bn_run(cuda, shape, groups, mode, torch.bfloat16)[0])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,width,f", [("_fused_smem", 24, 5), ("_wgmma_smem", 96, 10)])
def test_split_chain_refuses_a_plan_of_another_layout(cuda, monkeypatch, layout, width, f):
    """K2's fused chain and its warpgroup-MMA variant check the plan's
    shared-memory size against their own layout's: a plan copied wrong is
    refused, never launched."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net

    x = torch.randn(2, 4 * width, 9, f, device=cuda).bfloat16().contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(3 * width, width, 3, 3, device=cuda).bfloat16()
    stats = [torch.zeros(width, device=cuda)] * 3, [torch.ones(width, device=cuda)] * 3
    split_chain(x, w, *stats)
    size = getattr(res2net, layout)
    monkeypatch.setattr(res2net, layout, lambda *a: size(*a) - 16)
    with pytest.raises(kernels.KernelError, match="plan"):
        split_chain(x, w, *stats)


# K1 at the shapes its cluster design must get right: one frame, a partial
# last tile, the serving waves (3 s, 8 s, 128 s), a batch walking several
# utterances, every mel width it takes, and both flags off.
FBANK_CASES = [  # (batch, samples, num_bins, use_power, use_log)
    (1, 400, 80, True, True),
    (1, 401, 80, True, True),
    (1, 48000, 80, True, True),
    (1, 128000, 80, True, True),
    (1, 400 + 53 * 160 + 7, 80, True, True),  # 54 frames: 3 tiles and 6 frames
    (1, 2048000, 80, True, True),
    (3, 33333, 80, True, True),
    (2, 48000, 40, True, True),
    (1, 48000, 128, True, True),
    (1, 48000, 80, False, True),
    (1, 48000, 80, True, False),
]


def fbank_case(cuda, batch, samples, num_bins, use_power=True, use_log=True, seed=0):
    cfg = tfb.FbankConfig(num_bins=num_bins, dither=0.0, use_power=use_power,
                          use_log_fbank=use_log)
    w = tfb.pcm16(np.random.RandomState(seed).randn(batch, samples) * 3000)
    return torch.from_numpy(w.astype(np.float32)).to(cuda), cfg


# The GPU-only cases of K1 and K6 run as loops inside a few tests, each
# failure naming its case, to keep the count of collected tests down: the
# suite runs under pytest-xdist (`-n 6 --dist load`), which first hands
# each worker N / 6 / 4 consecutive collected tests, and
# tests/test_export_eval.py::TestExtractScoreCLI passes only when its
# tests share a worker (ROADMAP.md §3).
@pytest.mark.cuda
def test_fbank_kernel_matches_plain_at_every_shape(cuda):
    """K1 against its plain version, one launch a call: within 1e-3 in
    log-mel, and within 1e-4 of the largest value without the log."""
    for case in FBANK_CASES:
        batch, samples, num_bins, use_power, use_log = case
        w, cfg = fbank_case(cuda, batch, samples, num_bins, use_power, use_log)
        before = kernels.FBANK.launches
        got = tfb.fbank(w, cfg)
        assert kernels.FBANK.launches - before == 1, case
        want = tfb.fbank_reference(w, cfg)
        assert got.shape == want.shape == (batch, tfb.num_frames(samples, cfg), num_bins), case
        if use_log:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-3, msg=lambda m: f"{case}: {m}")
        else:
            assert rel(got, want) <= 1e-4, case


@pytest.mark.cuda
def test_fbank_kernel_reruns_bit_for_bit(cuda):
    """Each mel column is summed in bin order from the warps' sums in warp
    order: two runs on the same wave agree bit for bit."""
    for batch, samples in [(1, 128000), (3, 33333), (1, 2048000)]:
        w, cfg = fbank_case(cuda, batch, samples, 80, seed=1)
        assert torch.equal(tfb.fbank(w, cfg), tfb.fbank(w, cfg)), (batch, samples)


@pytest.mark.cuda
def test_fbank_kernel_takes_more_than_128_mel_bins(cuda):
    """A bank wider than 128 columns runs in 128-column passes, one C call:
    160 bins within 1e-3 in log-mel of the plain version."""
    w, cfg = fbank_case(cuda, 2, 48000, 160)
    before = kernels.FBANK.launches
    got = tfb.fbank(w, cfg)
    assert kernels.FBANK.launches - before == 1
    want = tfb.fbank_reference(w, cfg)
    assert got.shape == want.shape == (2, tfb.num_frames(48000, cfg), 160)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


def raw_crops(cuda, batch, feat_length=200, context=150, seed=2):
    """A raw-training microbatch on the card: int16 crops of max_crop_samples
    with ragged valid lengths (zero tails; some shorter than feat_length
    frames), their target offsets and pad shifts, and dither draws."""
    cfg = tfb.FbankConfig(dither=1.0)
    smax = tpipe.max_crop_samples(feat_length, context, cfg)
    rng = np.random.RandomState(seed)
    ns = np.minimum(smax, rng.randint(3000, 2 * smax, batch)).astype(np.int32)
    waves = np.zeros((batch, smax), np.int16)
    off, shift = np.zeros(batch, np.int32), np.zeros(batch, np.int32)
    for i, n in enumerate(ns):
        waves[i, :n] = tfb.pcm16(rng.randn(n) * 3000)
        frames = tfb.num_frames(int(n), cfg)
        if frames >= feat_length:
            off[i] = rng.randint(0, min(context, frames - feat_length) + 1)
        else:
            shift[i] = rng.randint(0, feat_length - frames + 1)
    g = torch.Generator(device=cuda).manual_seed(seed)
    noise = tfb.draw_noise(batch, smax, cfg, g, cuda)
    fields = [torch.from_numpy(x).to(cuda) for x in (waves, ns, off, shift)]
    return cfg, fields, noise


@pytest.mark.cuda
def test_fbank_dither_kernel_matches_plain(cuda):
    """K1's dithered variant against its plain version on the same draws,
    one launch a call on the dither path: crops with zero tails (the
    training shape's 80,240 samples, 500 frames) and ragged batches whose
    frame counts are no multiple of 32, one of 22 ms frames (352 samples: a
    warp's 44 leave a partial chunk of staged draws), one of 399-sample
    frames (the last warp's last row lies past the frame: its draw is
    clamped and its product dropped); within 1e-3 in log-mel, reruns bit
    for bit, the dither-off launch unchanged beside it; framed per-sample
    draws give the dither-off kernel on the dithered wave bit for bit; draws
    that are not contiguous are refused."""
    for batch, samples, frame_ms in [(6, None, 25.0), (3, 33333, 25.0), (3, 21111, 22.0),
                                     (3, 21111, 24.9375), (1, 4000, 25.0)]:
        if samples is None:
            cfg, (waves_i16, *_), noise = raw_crops(cuda, batch)
            waves = waves_i16.float()
        else:
            waves, _ = fbank_case(cuda, batch, samples, 80, seed=4)
            cfg = tfb.FbankConfig(dither=1.0, frame_length_ms=frame_ms)
            assert tfb.kernel_route(cfg) == "fast"
            noise = tfb.draw_noise(batch, samples, cfg, torch.Generator(device=cuda), cuda)
        before = kernels.function_launch_counts()
        got = tfb.fbank(waves, cfg, noise)
        after = kernels.function_launch_counts()
        assert after["fbank.fbank_f32:dither"] - before["fbank.fbank_f32:dither"] == 1
        assert after["fbank.fbank_f32:plain"] == before["fbank.fbank_f32:plain"]
        torch.testing.assert_close(got, tfb.fbank_reference(waves, cfg, noise), rtol=0,
                                   atol=1e-3, msg=lambda m: f"{(batch, samples)}: {m}")
        assert torch.equal(got, tfb.fbank(waves, cfg, noise)), (batch, samples)
        off = dataclasses.replace(cfg, dither=0.0)
        torch.testing.assert_close(tfb.fbank(waves, off), tfb.fbank_reference(waves, off),
                                   rtol=0, atol=1e-3)
    # one draw a sample, framed: the dithered kernel is the dither-off
    # kernel on the dithered wave, bit for bit (each draw reaches its frame
    # and sample; the dither scale is 1)
    u = torch.randn(waves.shape, device=cuda)
    framed = u.unfold(1, cfg.frame_length, cfg.frame_shift)[:, :noise.shape[1]].contiguous()
    assert torch.equal(tfb.fbank(waves, cfg, framed), tfb.fbank(waves + u, off))
    with pytest.raises(kernels.KernelError, match="contiguous"):
        tfb.fbank(waves, cfg, noise.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.cuda
def test_raw_pipeline_matches_plain_on_the_card(cuda):
    """ops/pipeline.py at the training shape (a microbatch of 16 crops):
    K1 (dithered) and K7 once each, the result within 1e-3 of the plain
    pipeline on the same draws, zero rows where the plain one has them,
    and a rerun bit-equal."""
    cfg, fields, noise = raw_crops(cuda, 16, seed=5)
    before = kernels.launch_counts()
    got = tpipe.waveform_to_features(*fields, cfg, 200, window=300, noise=noise)
    after = kernels.launch_counts()
    assert (after["fbank"] - before["fbank"], after["sliding_cmvn"] - before["sliding_cmvn"]) \
        == (1, 1)
    want = tpipe.waveform_to_features_reference(*fields, cfg, 200, window=300, noise=noise)
    assert got.shape == want.shape == (16, 200, 80)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    assert torch.equal((got == 0).all(-1), (want == 0).all(-1))  # the zero-padded rows
    assert torch.equal(got, tpipe.waveform_to_features(*fields, cfg, 200, window=300,
                                                       noise=noise))


# K6 at the shapes its slab design must get right. A row of center k starts
# at (k * B + b) * C floats: with C = 5994 and B odd the rows of center 1
# alternate between 16- and 8-byte alignment; "offset" stores cos_all 4
# bytes past a 16-byte boundary, so every row is misaligned and dcos_all
# (a fresh tensor) has another alignment than its input.
MARGIN_CASES = [  # (K, B, C, offset)
    (2, 256, 5994, False),
    (2, 255, 5994, False),
    (2, 7, 5994, True),
    (2, 37, 1001, False),
    (2, 9, 100, False),
    (2, 4, 3, True),
    (1, 6, 5994, False),
    (3, 6, 5994, True),
    (2, 1, 5994, False),
]


def margin_case(cuda, k, b, c, offset, seed=7):
    """cos_all with ties between centers (at row 0's label and elsewhere),
    a clipped maximum at row 1's label and at a column of row 2, labels at 0
    and C - 1; and the per-row gradient of the loss."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    vals = (torch.rand(k, b, c, generator=g, device=cuda) * 2 - 1) * 0.998
    labels = torch.randint(0, c, (b,), generator=g, device=cuda)
    labels[0] = 0
    labels[-1] = c - 1
    clipped = torch.zeros(k, b, c, dtype=torch.bool, device=cuda)
    if k > 1:
        vals[1:, 0, labels[0]] = vals[0, 0, labels[0]]
        vals[1:, :, : min(c, 40)] = vals[0, :, : min(c, 40)]
    if b > 1:
        vals[0, 1, labels[1]] = 1.03
        clipped[:, 1, labels[1]] = True
    if b > 2:
        j = (int(labels[2]) + 1) % c
        vals[:, 2, j] = -1.04
        clipped[:, 2, j] = True
    dloss = torch.rand(b, generator=g, device=cuda) + 0.5
    if offset:
        buf = torch.empty(vals.numel() + 1, device=cuda)
        cos = buf[1:].view(k, b, c)
        cos.copy_(vals)
        assert cos.data_ptr() % 16 != 0
    else:
        cos = vals
    return cos, labels, dloss, clipped


def margin_run(fn, cos, labels, dloss):
    ci = cos.detach().clone() if fn is margin_ce_reference else cos.detach()
    ci.requires_grad_(True)
    loss, correct = fn(ci, labels, 32.0, 0.2)
    loss.backward(dloss)
    return loss.detach(), correct, ci.grad


@pytest.mark.cuda
def test_margin_ce_kernel_matches_plain_at_every_shape(cuda):
    """K6 forward and backward against autograd of the plain version, one
    launch each: loss and dcos_all within 1e-4 of their largest magnitude,
    correct flags equal, ties split evenly, and an exactly zero gradient
    where the clip is active."""
    for case in MARGIN_CASES:
        k, b, c, offset = case
        cos, labels, dloss, clipped = margin_case(cuda, k, b, c, offset)
        before = dict(kernels.MARGIN_CE.fn_launches)
        l, cr, d = margin_run(margin_ce, cos, labels, dloss)
        assert {f: n - before[f] for f, n in kernels.MARGIN_CE.fn_launches.items()
                if n != before[f]} == {"margin_ce_fwd:slab": 1, "margin_ce_bwd:slab": 1}, case
        lr_, crr, dr = margin_run(margin_ce_reference, cos, labels, dloss)
        assert rel(l, lr_) <= 1e-4 and torch.equal(cr, crr) and rel(d, dr) <= 1e-4, case
        assert torch.all(d[clipped] == 0), case
        if k > 1:  # the tie at row 0's label: each center takes half
            assert d[0, 0, labels[0]] == d[1, 0, labels[0]] != 0, case


@pytest.mark.cuda
def test_margin_ce_kernel_reruns_bit_for_bit(cuda):
    """Each row's sums run in a fixed order: two runs agree bit for bit."""
    for case in [(2, 256, 5994, False), (3, 6, 5994, True)]:
        cos, labels, dloss, _ = margin_case(cuda, *case, seed=8)
        a, bb = (margin_run(margin_ce, cos, labels, dloss) for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(a, bb)), case


@pytest.mark.cuda
def test_margin_ce_plan_by_shape(cuda):
    """K6's slab path takes at most 8 centers and a 200 KB row; every other
    shape takes the streaming path. The C source decides; the plan reports
    it."""
    assert margin_ce_plan(2, 5994) == ("slab", 4 * 2 * 6000)
    assert margin_ce_plan(8, 5994)[0] == "slab"
    assert margin_ce_plan(2, 25597) == ("slab", 200 * 1024)
    assert margin_ce_plan(2, 25598) == ("stream", 0)
    assert margin_ce_plan(2, 30000) == ("stream", 0)
    assert margin_ce_plan(9, 100) == ("stream", 0)
    assert margin_ce_plan(10, 5994) == ("stream", 0)
    with pytest.raises(kernels.KernelError):
        margin_ce_plan(0, 5994)


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,c", [(2, 37, 30000), (10, 16, 5994), (9, 7, 3)])
def test_margin_ce_streaming_path_matches_plain(cuda, k, b, c):
    """The shapes the slab path refuses (K = 2 at C = 30000, K = 10) run on
    the streaming path, one launch a direction, within 1e-4 of autograd of
    the plain version, ties split evenly, zero gradient under the clip; and
    they rerun bit for bit."""
    cos, labels, dloss, clipped = margin_case(cuda, k, b, c, offset=True)
    before = dict(kernels.MARGIN_CE.fn_launches)
    l, cr, d = margin_run(margin_ce, cos, labels, dloss)
    assert {f: n - before[f] for f, n in kernels.MARGIN_CE.fn_launches.items() if n != before[f]} == {
        "margin_ce_fwd:stream": 1, "margin_ce_bwd:stream": 1}
    lr_, crr, dr = margin_run(margin_ce_reference, cos, labels, dloss)
    assert rel(l, lr_) <= 1e-4 and torch.equal(cr, crr) and rel(d, dr) <= 1e-4
    assert torch.all(d[clipped] == 0)
    assert d[0, 0, labels[0]] == d[1, 0, labels[0]] != 0
    again = margin_run(margin_ce, cos, labels, dloss)
    assert all(torch.equal(x, y) for x, y in zip((l, cr, d), again))


@pytest.mark.cuda
@pytest.mark.parametrize("k,c", [(2, 5994), (2, 30000)])
def test_margin_ce_kernel_at_unit_cosines(cuda, k, c):
    """Cosines of exactly +1 and -1 at a label and at a non-label column, on
    both paths: K6 equals the plain version (finite everywhere, zero
    gradient at a label whose |v| = 1)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    cos = (torch.rand(k, 4, c, generator=g, device=cuda) * 2 - 1) * 0.9
    labels = torch.tensor([3, 5, 7, 9], device=cuda)
    cos[0, 0, 3] = 1.0    # label, +1
    cos[:, 1, 5] = -1.0   # label, -1 (every center)
    cos[1, 2, 8] = 1.0    # non-label, +1
    cos[:, 3, 2] = -1.0   # non-label, -1
    dloss = torch.rand(4, generator=g, device=cuda) + 0.5
    l, cr, d = margin_run(margin_ce, cos, labels, dloss)
    lr_, crr, dr = margin_run(margin_ce_reference, cos, labels, dloss)
    for t in (l, d, lr_, dr):
        assert torch.isfinite(t).all()
    assert rel(l, lr_) <= 1e-4 and torch.equal(cr, crr) and rel(d, dr) <= 1e-4
    assert d[0, 0, 3] == 0 and torch.all(d[:, 1, 5] == 0)
    assert d[1, 2, 8] != 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_remat_step_on_the_card_updates_bn_once(cuda, policy):
    """A training step of a small Res2Net on the card with every block
    rematerialized against the plain step from the same state: K5 runs its
    forward again for each call inside the blocks (its backward once), K9
    (the stride-1 chains) again under None and not under dots_saveable, and
    the recomputed forward leaves the BN running statistics alone, so they
    are bit-equal to the plain step's; loss within 1e-5."""
    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
    from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant
    from voxsrc2020_speaker_verification_tpu_torch.training.trainer import (
        create_train_state, make_train_step)

    register_res2net_variant("res2net_remat_card", num_filters=(8, 16), block_sizes=(2, 1),
                             block_strides=(1, 2), width=(8, 16), split=4, output_dim=16)
    g = torch.Generator(device=cuda).manual_seed(3)
    feats = torch.randn(1, 16, 48, 40, generator=g, device=cuda)
    labels = torch.randint(0, 32, (1, 16), generator=g, device=cuda)
    runs = []
    for remat in (False, True):
        cfg = TrainConfig(model="res2net_remat_card", num_classes=32, dataset_length=160,
                          feat_dim=40, feat_length=48, batch_size=16, num_accumulation_steps=1,
                          bn_groups=2, bf16=True, remat=remat, remat_policy=policy if remat else None)
        state = create_train_state(cfg, cuda, seed=2)
        state.step = 40
        kernels.reset_launch_counts()
        state, m = make_train_step(cfg)(state, feats, labels)
        torch.cuda.synchronize()
        runs.append((state, float(m["loss"]), kernels.function_launch_counts()))
    (plain, lp, cp), (remat, lr_, cr) = runs
    # K5 again per block: bn1 and bn3; the stride-1 chains are K9 (split - 1
    # = 3 conv launches and the finishing one) and the stride-2 stage K11
    # (its conv launch and the finishing one), which run again under None
    # and not under dots_saveable (that policy keeps K9's and K11's
    # outputs); K9b is one statistics launch a chain and one grad launch a
    # group (the other groups' statistics folded into the grad launches),
    # K11b two launches a stage
    again = 2 + 2 + 2
    assert cr["bn_train.bn_cluster_fwd:row"] == cp["bn_train.bn_cluster_fwd:row"] + again
    assert cr["bn_train.bn_cluster_bwd:row"] == cp["bn_train.bn_cluster_bwd:row"]
    k9 = ("split_train.split_train_fwd", "split_train.split_train_finish")
    k9_again = 0 if policy == "dots_saveable" else 2 * (3 + 1)
    assert sum(cr[k] for k in k9) == sum(cp[k] for k in k9) + k9_again
    k11 = ("split_stride2_train.split_stride2_train_fwd",
           "split_stride2_train.split_stride2_train_finish")
    assert sum(cr[k] for k in k11) == sum(cp[k] for k in k11) + (0 if policy else 2) == (
        2 if policy else 4)
    for fn in ("bwd_stats", "bwd_grad"):
        key = f"split_stride2_train.split_stride2_train_{fn}"
        assert cr[key] == cp[key] == 1
    assert cr["split_train.split_train_bwd_stats"] == cp["split_train.split_train_bwd_stats"] == 2
    assert cr["split_train.split_train_bwd_grad"] == cp["split_train.split_train_bwd_grad"] == 2 * 3
    for k, v in plain.batch_stats.items():
        assert torch.equal(remat.batch_stats[k], v), k
    assert abs(lr_ - lp) <= 1e-5 * abs(lp)


def cmvn_loop_float64(x: np.ndarray, n: int, window: int, center: bool, norm_vars: bool,
                      min_window: int) -> np.ndarray:
    """Sliding CMVN of one (T, F) utterance with n valid frames, frame by
    frame in float64 (the window rule of ops/cmvn.py's docstring)."""
    t_len = x.shape[0]
    out = np.empty_like(x)
    xd = x.astype(np.float64)
    for t in range(t_len):
        if center:
            s = min(max(t - window // 2, 0), max(0, n - window))
            e = min(s + window, n)
        else:
            e = min(max(t + 1, min(min_window, n)), n)
            s = min(max(t - window + 1, 0), max(e - window, 0))
        w = xd[s:e]
        mean = w.sum(0) / max(e - s, 1)
        y = xd[t] - mean
        if norm_vars:
            y = y / np.sqrt(np.maximum((w * w).sum(0) / max(e - s, 1) - mean * mean, 1e-10))
        out[t] = y
    return out.astype(np.float32)


# K7 at the shapes cli/extract.py --cmvn device gives it: batches of 8 at
# every bucket (500-16000 frames, padded rows), and one utterance beyond
# the largest bucket alone at its exact length (60,000 frames)
CMVN_CASES = [(8, t) for t in (500, 1000, 2000, 4000, 8000, 16000)] + [(1, 60000)]


@pytest.mark.cuda
def test_sliding_cmvn_kernel_matches_plain_at_every_shape(cuda):
    """K7 against the float64 plain version within 1e-5 absolute, one
    launch a call, centred at every extraction shape; every flag (trailing,
    norm_vars, min_window, no num_valid) at two of them."""
    from voxsrc2020_speaker_verification_tpu_torch.data.dataset import sliding_cmn_np

    rng = np.random.RandomState(0)
    flags = [dict(center=True, norm_vars=False)]
    for b, t in CMVN_CASES:
        x = (rng.randn(b, t, 80) * 3 + 12).astype(np.float32)
        n = np.array([t] + list(rng.randint(1, t + 1, b - 1)), np.int32)
        xs, ns = torch.from_numpy(x).to(cuda), torch.from_numpy(n).to(cuda)
        cases = flags if t not in (2000, 60000) else flags + [
            dict(center=False, norm_vars=False), dict(center=True, norm_vars=True),
            dict(center=False, norm_vars=True, min_window=50), dict(window=301)]
        for kw in cases:
            before = kernels.SLIDING_CMVN.launches
            got = tcmvn.sliding_cmvn(xs, ns, **kw)
            assert kernels.SLIDING_CMVN.launches - before == 1, (b, t, kw)
            want = tcmvn.sliding_cmvn_reference(xs, ns, **kw)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                       msg=lambda m: f"{(b, t, kw)}: {m}")
        # the host's float64 CMN of each utterance, on its valid frames
        got = tcmvn.sliding_cmvn(xs, ns).cpu().numpy()
        for i in range(b):
            np.testing.assert_allclose(got[i, :n[i]], sliding_cmn_np(x[i, :n[i]]),
                                       rtol=0, atol=1e-5, err_msg=str((b, t, i)))
        del xs, ns
    # all frames valid, and a frame-by-frame float64 loop at a short length
    x = (rng.randn(2, 700, 80) * 3 + 12).astype(np.float32)
    for kw in (dict(center=True, norm_vars=True), dict(center=False, norm_vars=False)):
        got = tcmvn.sliding_cmvn(torch.from_numpy(x).to(cuda), **kw).cpu().numpy()
        for i in range(2):
            want = cmvn_loop_float64(x[i], 700, 300, min_window=100, **kw)
            np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_sliding_cmvn_kernel_reruns_bit_for_bit(cuda):
    """Each output's sums run in one order: two runs agree bit for bit."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(8, 4000, 80) * 3 + 12).astype(np.float32)).to(cuda)
    n = torch.from_numpy(rng.randint(1, 4001, 8).astype(np.int32)).to(cuda)
    for kw in (dict(), dict(center=False, norm_vars=True)):
        assert torch.equal(tcmvn.sliding_cmvn(x, n, **kw), tcmvn.sliding_cmvn(x, n, **kw))


@pytest.mark.cuda
def test_sliding_cmvn_kernel_never_takes_the_plain_path(cuda, monkeypatch):
    """On a CUDA tensor every flag goes to K7: the plain version is never
    called, and a dtype K7 does not take raises."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(tcmvn, "sliding_cmvn_reference", plain)
    x = torch.randn(3, 900, 80, device=cuda) + 5
    n = torch.tensor([900, 400, 3], device=cuda)
    for kw in (dict(), dict(center=False), dict(norm_vars=True), dict(min_window=10),
               dict(window=17, center=False, norm_vars=True)):
        assert torch.isfinite(tcmvn.sliding_cmvn(x, n, **kw)).all()
        assert torch.isfinite(tcmvn.sliding_cmvn(x[0], **kw)).all()
    with pytest.raises(kernels.KernelError):
        tcmvn.sliding_cmvn(x.bfloat16(), n)


# K7's tile design (ops/cmvn.py:sliding_cmvn_plan): each CTA stages the rows
# its tile's windows cover, from the utterance's own n. Absolute tolerance
# against float64 on features of 12 +- 3.
TOL_CMVN = 1e-5


def cmvn_case(cuda, x, n, loop_rows=(), **kw):
    """One K7 call against the float64 plain version on every frame and the
    frame-by-frame float64 loop on ``loop_rows``; one launch, and a rerun
    bit for bit. Where norm_vars floors the variance (n <= 1), y is (x -
    mean) * 1e5, whose float32 spacing is 0.125: TOL_CMVN plus one float32
    rounding of y (rtol 2**-23), since the two float64 references already
    round such y apart (one multiplies by rsqrt, one divides by sqrt)."""
    xs = torch.from_numpy(x).to(cuda)
    ns = None if n is None else torch.from_numpy(np.asarray(n, np.int32)).to(cuda)
    before = kernels.SLIDING_CMVN.launches
    got = tcmvn.sliding_cmvn(xs, ns, **kw)
    assert kernels.SLIDING_CMVN.launches - before == 1, kw
    assert torch.equal(got, tcmvn.sliding_cmvn(xs, ns, **kw)), kw
    floored = kw.get("norm_vars", False) and n is not None and min(n) <= 1
    rtol = 2.0 ** -23 if floored else 0.0
    torch.testing.assert_close(got, tcmvn.sliding_cmvn_reference(xs, ns, **kw), rtol=rtol,
                               atol=TOL_CMVN, msg=lambda m: f"{x.shape} n={n} {kw}: {m}")
    got = got.cpu().numpy()
    args = dict(window=300, center=True, norm_vars=False, min_window=100)
    args.update(kw)
    for i in loop_rows:
        ni = x.shape[1] if n is None else min(max(int(n[i]), 0), x.shape[1])
        np.testing.assert_allclose(got[i], cmvn_loop_float64(x[i], ni, **args), rtol=rtol,
                                   atol=TOL_CMVN, err_msg=f"{x.shape} row {i} n={ni} {kw}")


def cmvn_feats(seed, b, t, f=80):
    return (np.random.RandomState(seed).randn(b, t, f) * 3 + 12).astype(np.float32)


K7_FLAGS = [dict(center=c, norm_vars=v) for c in (True, False) for v in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", K7_FLAGS,
                         ids=lambda kw: f"center{kw['center']:d}-vars{kw['norm_vars']:d}")
def test_sliding_cmvn_kernel_at_tile_edges_and_past_n(cuda, kw):
    """Valid counts at the plan's tile edges +- 1, at w - 1, w, w + 1, 0, 1
    and T, at lengths of one frame, around w and around the tile size (both
    plans: 256 frames x 16 bins, 512 x 8); and an 8001-frame row in the
    16,000 bucket, whose tiles past n (8,192 on) stage the last window, rows
    7,701-8,000, up to 7,800 rows to their left."""
    for b, t in ((9, 1), (9, 299), (9, 300), (9, 301), (9, 255), (9, 257), (9, 1023),
                 (9, 1025), (40, 513)):
        tt = tcmvn.sliding_cmvn_plan(b, t, 80, 300, kw["center"], kw["norm_vars"])["tt"]
        n = [0, 1, 299, 300, 301, tt - 1, tt, tt + 1, t] + list(range(t, t - b + 9, -1))
        cmvn_case(cuda, cmvn_feats(t, b, t), n, loop_rows=range(9), **kw)
    t = 16000
    tt = tcmvn.sliding_cmvn_plan(8, t, 80, 300, kw["center"], kw["norm_vars"])["tt"]
    n = [t, 8001, 30 * tt - 1, 30 * tt + 1, tt - 1, tt + 1, 301, 0]
    cmvn_case(cuda, cmvn_feats(7, 8, t), n, loop_rows=(1,), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("min_window", [100, 250, 450])
def test_sliding_cmvn_kernel_trailing_min_window_above_n(cuda, norm_vars, min_window):
    """The trailing rule where n < min_window (every window is [0, n)), at
    min_window below and above w (then one window holds up to min_window
    rows, and the tile's extent reach grows with it)."""
    n = [50, 99, 249, 449, 700, 0, 1, 300]
    cmvn_case(cuda, cmvn_feats(min_window, 8, 700), n, loop_rows=range(8), center=False,
              norm_vars=norm_vars, min_window=min_window)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", CMVN_CASES)
def test_sliding_cmvn_kernel_norm_vars_at_every_bucket(cuda, b, t):
    """norm_vars, centred and trailing, at every extraction shape."""
    rng = np.random.RandomState(t)
    n = [t] + list(rng.randint(2, t + 1, b - 1))
    x = cmvn_feats(t + 1, b, t)
    for center in (True, False):
        cmvn_case(cuda, x, n, loop_rows=(1,) if t <= 2000 else (), center=center,
                  norm_vars=True)


@pytest.mark.cuda
def test_sliding_cmvn_kernel_no_valid_frames(cuda):
    """n = 0 in every row: the window is empty (count 1, sums 0), so y = x,
    or x * 1e5 under the floored variance."""
    x = cmvn_feats(3, 3, 500)
    for kw in K7_FLAGS:
        cmvn_case(cuda, x, [0, 0, 0], loop_rows=range(3), **kw)


@pytest.mark.cuda
def test_sliding_cmvn_kernel_other_widths_and_long_windows(cuda):
    """Bin counts that are not a multiple of 16 (30: a group of 14) or of 4
    (5: 4-byte copies), and windows whose extent does not fit shared memory
    (the plan's unstaged path, rows read from global memory)."""
    for f, kw in ((30, dict()), (5, dict(center=False, norm_vars=True)), (30, dict(window=9))):
        cmvn_case(cuda, cmvn_feats(f, 3, 400, f), [400, 123, 7], loop_rows=range(3), **kw)
    for kw in (dict(window=6000), dict(window=4500, center=False, norm_vars=True),
               dict(window=300, center=False, min_window=5200)):
        plan = tcmvn.sliding_cmvn_plan(2, 5000, 80, kw["window"], kw.get("center", True),
                                       kw.get("norm_vars", False), kw.get("min_window", 100))
        assert not plan["staged"] and plan["seg"] % 2 == 1, plan
        cmvn_case(cuda, cmvn_feats(11, 2, 5000), [5000, 3001], loop_rows=(1,), **kw)


# K8 / K8b at the shapes of the attentive-stats paths (B, C, T, W): the
# res2net200_att serving head (masked) and training microbatch, ECAPA-512's
# training head at W = 1, ECAPA serving at T = 1000, and ragged cases (C =
# 20 and T = 1; C not a multiple of the 16-byte vector)
ATT_SHAPES = [((128, 1024, 125, 10), True), ((128, 1024, 25, 10), False),
              ((256, 1536, 200, 1), False), ((16, 1536, 1000, 1), True),
              ((4, 20, 1, 3), False), ((5, 36, 7, 2), True)]


def att_case(cuda, shape, masked, dtype, seed=11):
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, c, t, w = shape
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5)
    s = torch.randn(shape, generator=g, device=cuda) * 3
    mask = None
    if masked:
        lens = torch.randint(1, t + 1, (b,), generator=g, device=cuda)
        lens[-1] = 0  # a row masked throughout: uniform weights
        mask = (torch.arange(t, device=cuda)[None] < lens[:, None]).float()
        x = x * mask[:, None, :, None]
    cl = torch.channels_last
    return x.to(dtype).contiguous(memory_format=cl), s.to(dtype).contiguous(memory_format=cl), mask


def att_run(fn, x, s, mask, dout):
    xi, si = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    y = fn(xi, si, mask)
    y.backward(dout)
    return y.detach(), xi.grad, si.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_att_pool_kernel_matches_plain(cuda, dtype):
    """K8 and K8b against autograd of the plain version on the same inputs,
    relative to each output's largest magnitude: float32 against the plain
    version in float64, no further from it than twice the float32 plain
    version is, or 1e-4 (where a column's weights peak on a few frames, q -
    mean^2 cancels in any float32 computation, the JAX package's included:
    at the serving shape both stray ~1.2e-4 in dx on the H100); bfloat16
    against the float32 plain version within 2e-2; one launch a direction,
    reruns bit for bit."""
    for shape, masked in ATT_SHAPES:
        x, s, mask = att_case(cuda, shape, masked, dtype)
        b, c, _, w = shape
        dout = torch.randn((b, 2 * c, 1, w), device=cuda).to(dtype).contiguous(
            memory_format=torch.channels_last)
        before = dict(kernels.ATT_POOL.fn_launches)
        got = att_run(tops.att_pool, x, s, mask, dout)
        after = kernels.ATT_POOL.fn_launches
        assert {f: after[f] - before[f] for f in after} == {"att_pool_fwd": 1, "att_pool_bwd": 1}
        if dtype == torch.float32:
            want = att_run(tops.att_pool_reference, x.double(), s.double(), mask, dout.double())
            plain = att_run(tops.att_pool_reference, x, s, mask, dout)
            tols = [max(1e-4, 2 * rel(p, r)) for p, r in zip(plain, want)]
            del plain
        else:
            want = att_run(tops.att_pool_reference, x, s, mask, dout)
            tols = [2e-2] * 3
        for name, a, r, tol in zip(("out", "dx", "ds"), got, want, tols):
            assert rel(a, r) <= tol, (shape, name, rel(a, r), tol)
        again = att_run(tops.att_pool, x, s, mask, dout)
        assert all(torch.equal(a, r) for a, r in zip(got, again)), shape
        del x, s, got, want, again
        torch.cuda.empty_cache()


# K8's forward at the three heads it serves: res2net200_att's serving and
# training heads, ECAPA-512's (B, C, T, W, masked)
ATT_HEADS = [((128, 1024, 125, 10), True), ((128, 1024, 25, 10), False),
             ((256, 1536, 200, 1), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", ATT_HEADS)
def test_att_pool_forward_at_the_heads(cuda, shape, masked):
    """K8's forward (its rows split over thread groups, their sums merged in
    a fixed order) at each head: float32 pooled rows no further from the
    float64 plain version than twice the float32 plain version, or 1e-4;
    bfloat16 within 2e-2 of the float32 plain version; the saved stats
    (max, sum of exp, mean, E_p x^2) equal to the float64 plain softmax's
    within 1e-4 of their largest magnitude; reruns bit for bit; a row masked
    throughout is the plain mean over T."""
    from voxsrc2020_speaker_verification_tpu_torch.ops.nn import POOL_EPSILON

    b, c, t, w = shape
    for dtype in (torch.float32, torch.bfloat16):
        x, s, mask = att_case(cuda, shape, masked, dtype, seed=5)
        got = tops.att_pool(x, s, mask)
        assert torch.equal(got, tops.att_pool(x, s, mask))
        if dtype == torch.float32:
            want = tops.att_pool_reference(x.double(), s.double(), mask)
            plain = tops.att_pool_reference(x, s, mask)
            assert rel(got, want) <= max(1e-4, 2 * rel(plain, want)), shape
            if masked:
                torch.testing.assert_close(got[-1, :c, 0], x[-1].mean(dim=1), rtol=1e-5, atol=1e-5)
            # the saved stats K8b reads, against a float64 softmax
            stats = torch.empty((4, b, w, c), device=cuda)
            kernels.ATT_POOL.launch("att_pool_fwd", cuda, 0, x.data_ptr(), s.data_ptr(),
                                    None if mask is None else mask.data_ptr(),
                                    torch.empty_like(got).data_ptr(), stats.data_ptr(),
                                    b, t, w, c, POOL_EPSILON)
            sd = s.double().permute(0, 3, 1, 2)  # (B, W, C, T)
            xd = x.double().permute(0, 3, 1, 2)
            if mask is not None:
                sd = torch.where(mask[:, None, None, :] > 0, sd, torch.full_like(sd, -1e30))
            mx = sd.max(dim=-1).values
            e = torch.exp(sd - mx[..., None])
            ref = torch.stack([mx, e.sum(-1), (e * xd).sum(-1) / e.sum(-1),
                               (e * xd * xd).sum(-1) / e.sum(-1)])
            for k in range(4):
                assert rel(stats[k], ref[k]) <= 1e-4, (shape, k)
        else:
            assert rel(got, tops.att_pool_reference(x, s, mask)) <= 2e-2, shape
        del x, s, got
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_att_pool_kernel_edges(cuda):
    """A row masked throughout (the plain mean over all T, ds = 0), a row
    of constant x and scores (q - mean^2 == 0 exactly: dx = dmean / T, ds =
    0), a misaligned pointer (the single-channel path), and what the wrapper
    refuses: mismatched scores, a non-channels_last x, scores or a mask on
    the CPU beside CUDA x."""
    shape = (2, 16, 8, 3)
    x, s, _ = att_case(cuda, shape, False, torch.float32)
    mask = torch.tensor([[1.0] * 8, [0.0] * 8], device=cuda)
    x[0], s[0] = 2.0, 0.75
    dout = torch.randn((2, 32, 1, 3), device=cuda).contiguous(memory_format=torch.channels_last)
    y, dx, ds = att_run(tops.att_pool, x, s, mask, dout)
    torch.testing.assert_close(y[1, :16, 0], x[1].mean(dim=1), rtol=1e-5, atol=1e-5)
    assert torch.all(ds[1] == 0)
    torch.testing.assert_close(dx[0], (dout[0, :16] / 8).expand(16, 8, 3), rtol=1e-6, atol=1e-6)
    assert torch.all(ds[0].abs() <= 1e-6)
    # a view one element into a larger buffer: not 16-byte aligned
    buf = torch.randn(2 * 8 * 3 * 16 + 1, device=cuda)
    xm = buf[1:].view(2, 8, 3, 16).permute(0, 3, 1, 2)
    assert xm.is_contiguous(memory_format=torch.channels_last) and xm.data_ptr() % 16
    for a, r in zip(att_run(tops.att_pool, xm, s, None, dout),
                    att_run(tops.att_pool_reference, xm, s, None, dout)):
        assert rel(a, r) <= 1e-4
    with pytest.raises(ValueError):
        tops.att_pool(x, s[:, :8], mask)
    with pytest.raises(kernels.KernelError):
        tops.att_pool(x.contiguous(), s.contiguous(), mask)
    with pytest.raises(kernels.KernelError):  # scores on another device
        tops.att_pool(x, s.cpu(), mask)
    with pytest.raises(kernels.KernelError):  # a mask on the CPU
        tops.att_pool(x, s, mask.cpu())


def bn_designs_taken(fn):
    """(K3's paths, K5's designs) that ``fn()`` launched, from the launch
    counts by path."""
    before = kernels.function_launch_counts()
    fn()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in kernels.function_launch_counts().items()
             if v != before[k]}
    k3 = {k.split(":")[1] for k in delta if k.startswith("bn_act.bn_act:")}
    k5 = {k5_design_of(k) for k in delta if k.startswith("bn_train.") and "span" not in k}
    return k3, k5


def k5_design_of(key):
    """K5's design from a launch-count key: "fold" / "cluster" (the cluster
    design on folded rows or on rows), "head" (2-D calls; "head:single" on
    single-channel lanes) or "multi"."""
    if "cluster" in key:
        return "fold" if key.endswith(":fold") else "cluster"
    if "bn_head" in key:
        return "head" if key.endswith(":vector") else "head:single"
    return "multi"


def k5_design_of_plan(plan):
    if plan["design"] == "cluster":
        return "fold" if plan["fold"] > 1 else "cluster"
    if plan["design"] == "head":
        return "head" if plan["lanes"] == "vector" else "head:single"
    return "multi"


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3, 10])
def test_bn_kernels_take_any_channel_count(cuda, channels):
    """K3 (relu, both shortcut modes, mask) and K5 (forward, running
    update, backward, groups 1 and 8) at channel counts that are not
    multiples of 4 (dpn68's 10-channel stem), against the plain versions on
    the same inputs; dpn68's stem shape at C = 10; reruns bit for bit. Each
    call takes the design its plan names, read off the launch counts: the
    folded rows where n % fold == 0 (K5) or F % fold == 0 (K3), else the
    multi-kernel design or single channels (a K3 case with F % fold != 0:
    F = 5; a K5 case whose groups start off a 16-byte boundary: n = 90 rows
    of 10 bf16 channels at groups 8)."""
    shapes = [(16, channels, 9, 5), (64, channels, 25, 10)]
    if channels == 10:
        shapes.append((256, 10, 200, 80))
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            x, (m, v) = bn_case(cuda, shape, dtype, 3)
            s, (sm, sv) = bn_case(cuda, shape, dtype, 4)
            t = shape[2]
            mask = (torch.arange(t, device=cuda)[None] < torch.randint(
                1, t + 1, (shape[0],), device=cuda)[:, None]).float()
            k3_plan = tops.bn_act_plan(shape, dtype)
            for kw in (dict(relu=True, mask=mask), dict(shortcut=s),
                       dict(relu=True, shortcut=s, shortcut_mean=sm, shortcut_var=sv)):
                got = tops.bn_act(x, m, v, **kw)
                assert rel(got, tops.bn_act_reference(x, m, v, **kw)) <= tol, (shape, kw.keys())
                assert torch.equal(got, tops.bn_act(x, m, v, **kw))
                k3, _ = bn_designs_taken(lambda: tops.bn_act(x, m, v, **kw))
                assert k3 == {k3_plan["design"]}, (shape, dtype)
            dy = bn_case(cuda, shape, dtype, 5)[0]
            for groups in (1, 8):
                want = k5_design_of_plan(tops.bn_train_plan(shape, groups, dtype, 0, True))
                runs = []
                for fn in (tops.bn_train, tops.bn_train_reference, tops.bn_train):
                    xi = x.clone().requires_grad_(True)
                    st = [m.clone(), v.clone()]

                    def run():
                        y = fn(xi, st[0], st[1], groups=groups, relu=True)
                        y.backward(dy)
                        return y
                    if fn is tops.bn_train_reference:
                        y = run()
                    else:
                        holder = []
                        _, k5 = bn_designs_taken(lambda: holder.append(run()))
                        y = holder[0]
                        assert k5 == {want}, (shape, dtype, groups)
                    runs.append((y.detach(), xi.grad, *st))
                (y, dx, rm, rv), (yr, dxr, rmr, rvr), again = runs
                same = (y > 0) == (yr > 0)
                assert int((~same).sum()) <= 1
                assert rel(y, yr) <= tol and rel(dx * same, dxr * same) <= tol, (shape, groups)
                assert rel(rm, rmr) <= 1e-4 and rel(rv, rvr) <= 1e-4
                assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
    # the designs by shape: F % 4 != 0 keeps K3 on single channels in bf16;
    # groups of 90 rows of 10 bf16 channels start off a 16-byte boundary
    if channels == 10:
        assert tops.bn_act_plan((16, 10, 9, 5), torch.bfloat16)["design"] == "single"
        assert tops.bn_train_plan((16, 10, 9, 5), 8, torch.bfloat16, 0, True)["design"] == "multi"
        assert tops.bn_act_plan((256, 10, 200, 80), torch.bfloat16)["design"] == "fold"
        assert tops.bn_train_plan((256, 10, 200, 80), 8, torch.bfloat16, 0, True)["fold"] == 100
        # a tensor one element into its buffer: not 16-byte aligned, so K3
        # takes single channels there and K5 the multi-kernel design
        buf = torch.randn(16 * 10 * 12 * 8 + 1, device=cuda).bfloat16()
        xm = buf[1:].view(16, 12, 8, 10).permute(0, 3, 1, 2)
        assert xm.is_contiguous(memory_format=torch.channels_last) and xm.data_ptr() % 16
        m, v = torch.zeros(10, device=cuda), torch.ones(10, device=cuda)
        assert tops.bn_act_plan(tuple(xm.shape), torch.bfloat16)["design"] == "fold"
        k3, _ = bn_designs_taken(lambda: tops.bn_act(xm, m, v, relu=True))
        assert k3 == {"single"}
        assert rel(tops.bn_act(xm, m, v, relu=True),
                   tops.bn_act_reference(xm, m, v, relu=True)) <= 2e-2
        _, k5 = bn_designs_taken(lambda: tops.bn_train(xm, m.clone(), v.clone(), groups=8))
        assert k5 == {"multi"}


# K5's head design at the 2-D calls: the bench step's pre_bn and post_bn
# (bn_groups 8; the post_bn on single-channel lanes), TDNN's pre_bn (1024
# rows), --single-chip's pre_bn (512 rows in 16 groups), a C that does not
# fill 16-byte vectors and B whose slabs are read in two rounds (4096 rows,
# one group) on either lanes
HEAD_CASES = [((256, 10240), 8), ((256, 192), 8), ((1024, 3072), 8), ((512, 10240), 16),
              ((64, 41), 8), ((4096, 64), 1), ((4096, 2048), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", HEAD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_head_kernel_matches_plain(cuda, shape, groups, dtype):
    """K5's head design forward (output, running update; none inside
    running_update(False)) and backward against autograd of the plain
    version on the same inputs, at test_bn_train_kernel_matches_plain's
    tolerances (float32 1e-4, bf16 2e-2 relative to each output's largest
    magnitude; running statistics 1e-4); one launch a direction, on the
    lanes the plan names (vector lanes, single-channel lanes where C does
    not fill 16-byte vectors or x lies off a 16-byte boundary) and no other
    K5 launch; reruns bit for bit."""
    x, (rm, rv) = bn_case(cuda, shape, dtype, 3)
    dy = bn_case(cuda, shape, dtype, 5)[0]
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    buf[1:].copy_(x.flatten())
    misaligned = buf[1:].view(shape)
    assert misaligned.data_ptr() % 16
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    y_aligned = None
    for xin in (x, misaligned):
        aligned = xin.data_ptr() % 16 == 0
        plan = tops.bn_train_plan(shape, groups, dtype, 0, False, aligned)
        assert plan["design"] == "head"
        runs = []
        for fn in (tops.bn_train, tops.bn_train_reference, tops.bn_train):
            xi, st = xin.clone() if fn is tops.bn_train_reference else xin, [rm.clone(), rv.clone()]
            xi = xi.detach().requires_grad_(True)
            before = kernels.function_launch_counts()
            y = fn(xi, st[0], st[1], groups=groups)
            y.backward(dy)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in kernels.function_launch_counts().items()
                     if v != before[k] and k.startswith("bn_train.")}
            if fn is tops.bn_train:
                path = plan["lanes"]
                assert delta == {f"bn_train.bn_head_fwd:{path}": 1,
                                 f"bn_train.bn_head_bwd:{path}": 1}, (shape, dtype, delta)
            runs.append((y.detach(), xi.grad, *st))
        (y, dx, m, v), (yr, dxr, mr, vr), again = runs
        assert rel(y, yr) <= tol and rel(dx, dxr) <= tol, (shape, dtype, aligned)
        assert rel(m, mr) <= 1e-4 and rel(v, vr) <= 1e-4
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
        y_aligned = y if y_aligned is None else y_aligned
    # a rematerialized forward leaves the running statistics alone
    st = [rm.clone(), rv.clone()]
    with tops.running_update(False):
        y = tops.bn_train(x, st[0], st[1], groups=groups)
    assert torch.equal(st[0], rm) and torch.equal(st[1], rv)
    assert torch.equal(y, y_aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_head_kernel_shortcut_modes(cuda, dtype):
    """The head design with relu and both shortcut modes, on vector lanes
    at (256, 2048) and on single-channel lanes at the bench's post_bn width
    and a C that does not fill 16-byte vectors, against the plain version
    (x, shortcut gradients and all running statistics)."""
    for shape in ((256, 2048), (256, 192), (48, 20)):
        x, (rm, rv) = bn_case(cuda, shape, dtype, 3)
        s, (srm, srv) = bn_case(cuda, shape, dtype, 4)
        dy = bn_case(cuda, shape, dtype, 5)[0]
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for mode in ("raw_shortcut", "bn_shortcut"):
            outs = []
            for fn in (tops.bn_train, tops.bn_train_reference):
                xi, si = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
                st = [t.clone() for t in (rm, rv, srm, srv)]
                kw = dict(groups=4, relu=True, shortcut=si)
                if mode == "bn_shortcut":
                    kw.update(shortcut_running_mean=st[2], shortcut_running_var=st[3])
                y = fn(xi, st[0], st[1], **kw)
                y.backward(dy)
                outs.append((y.detach(), xi.grad, si.grad, st))
            (y, dx, ds, st), (yr, dxr, dsr, str_) = outs
            # gradients where both take the same relu decision (RELU_FLIPS)
            same = (y > 0) == (yr > 0)
            assert int((~same).sum()) <= 1
            assert rel(y, yr) <= tol and rel(dx * same, dxr * same) <= tol, (shape, mode)
            assert rel(ds * same, dsr * same) <= tol, (shape, mode)
            for a, b in zip(st, str_):
                assert rel(a, b) <= 1e-4


# ---------------------------------------------------------------------------
# K1's general path, K5's spanning mode and K6's class-sharded mode
# ---------------------------------------------------------------------------

# configs the fast design refuses: 32 kHz (800-sample frame, 512 FFT bins),
# a 64 ms frame at 16 kHz (1024 samples), a 32 ms frame (512 samples: its
# layout exceeds a CTA's shared memory), 600 mel bins at 32 kHz
GENERAL_FBANK = [dict(sample_rate=32000), dict(frame_length_ms=64.0),
                 dict(frame_length_ms=32.0), dict(sample_rate=32000, num_bins=600)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", GENERAL_FBANK, ids=["32k", "64ms", "32ms", "32k-600"])
@pytest.mark.parametrize("dither", [False, True])
def test_fbank_general_path_matches_plain(cuda, kw, dither):
    """K1's general path (fbank_general_f32), with and without dither,
    against the plain version at 1e-3 log-mel, one launch a call, reruns
    bit for bit."""
    cfg = tfb.FbankConfig(dither=1.0 if dither else 0.0, **kw)
    assert tfb.kernel_route(cfg) == "general"
    rng = np.random.RandomState(11)
    n = 3 * cfg.sample_rate + 123
    waves = torch.from_numpy(tfb.pcm16(rng.randn(2, n) * 3000).astype(np.float32)).to(cuda)
    noise = None
    if dither:
        noise = torch.from_numpy(rng.randn(2, tfb.num_frames(n, cfg), cfg.frame_length)
                                 .astype(np.float32)).to(cuda)
    key = f"fbank_general_f32:{'dither' if dither else 'plain'}"
    before = kernels.FBANK.fn_launches[key]
    got = tfb.fbank(waves, cfg, noise)
    assert kernels.FBANK.fn_launches[key] == before + 1
    want = tfb.fbank_reference(waves, cfg, noise)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-3
    assert torch.equal(got, tfb.fbank(waves, cfg, noise))


@pytest.mark.cuda
@pytest.mark.parametrize("kw,seconds,batch", [(dict(sample_rate=48000), 3.0, 2),
                                              (dict(sample_rate=32000), 128.0, 1),
                                              (dict(sample_rate=32000), 4.0, 8),
                                              (dict(frame_length_ms=64.0), 4.0, 8)],
                         ids=["48k", "32k-128s", "32k-8x4s", "64ms-8x4s"])
@pytest.mark.parametrize("dither", [False, True])
def test_fbank_general_path_long_waves_and_batches(cuda, kw, seconds, batch, dither):
    """K1's general path at 48 kHz (16 bin tiles), a 128 s wave at 32 kHz
    (200 frame tiles) and batches of 8 waves, dithered and not, against the
    plain version at 1e-3 log-mel; reruns bit for bit."""
    cfg = tfb.FbankConfig(dither=1.0 if dither else 0.0, **kw)
    assert tfb.kernel_route(cfg) == "general"
    rng = np.random.RandomState(12)
    n = int(seconds * cfg.sample_rate)
    waves = torch.from_numpy(tfb.pcm16(rng.randn(batch, n) * 3000).astype(np.float32)).to(cuda)
    noise = None
    if dither:
        noise = torch.from_numpy(rng.randn(batch, tfb.num_frames(n, cfg), cfg.frame_length)
                                 .astype(np.float32)).to(cuda)
    got = tfb.fbank(waves, cfg, noise)
    want = tfb.fbank_reference(waves, cfg, noise)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-3
    assert torch.equal(got, tfb.fbank(waves, cfg, noise))


def span_inputs(cuda, shape, dtype):
    """x, the shortcut, dy and the four running statistics of span_run."""
    x, s, dy = (bn_case(cuda, shape, dtype, seed)[0] for seed in (3, 4, 5))
    g = torch.Generator(device=cuda).manual_seed(6)
    rm, srm = (torch.randn(shape[1], generator=g, device=cuda) * 0.1 for _ in range(2))
    rv, srv = (torch.rand(shape[1], generator=g, device=cuda) + 0.5 for _ in range(2))
    return x, s, dy, [rm, rv, srm, srv]


def whole_batch(fn, x, s, dy, running, groups, mode, update=True):
    """The whole batch through ``fn`` (``bn_train``'s signature) and
    autograd: (y, dx, ds or None, the running statistics it updated)."""
    relu, sc, bn_sc = mode != "plain", mode in ("raw_shortcut", "bn_shortcut"), mode == "bn_shortcut"
    xi, si = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    st = [None if t is None else t.clone() for t in running]
    kw = dict(groups=groups, relu=relu)
    if sc:
        kw["shortcut"] = si
    if bn_sc:
        kw.update(shortcut_running_mean=st[2], shortcut_running_var=st[3])
    with tops.running_update(update):
        yw = fn(xi, st[0], st[1], **kw)
    yw.backward(dy)
    return yw.detach(), xi.grad, si.grad if sc else None, st


def bn_train_float64(x, running_mean, running_var, *, groups=1, relu=False, shortcut=None,
                     shortcut_running_mean=None, shortcut_running_var=None):
    """Whole-batch training BN with every moment and product in float64 (no
    running update): the yardstick of the float32 versions."""
    def norm(t):
        rows = t.double().movedim(1, -1)
        g = rows.reshape(groups, -1, t.shape[1])
        mean = g.mean(1, keepdim=True)
        var = torch.square(g).mean(1, keepdim=True) - torch.square(mean)
        return ((g - mean) * torch.rsqrt(var + tops.BN_EPSILON)).reshape(rows.shape).movedim(-1, 1)

    y = norm(x)
    if shortcut is not None:
        y = y + (norm(shortcut) if shortcut_running_mean is not None else shortcut.double())
    return torch.relu(y) if relu else y


def span_run(cuda, shape, groups, mode, dtype, ranks=2, update=True):
    """K5's spanning mode over ``ranks`` blocks of one batch in one process
    (the all-reduce replaced by a sum of the blocks' partials): [y, dx, (ds,)
    running statistics of each block], then the same for the whole batch
    through K5 (autograd). ``update=False`` runs both with null running
    statistics (a rematerialized recompute)."""
    x, s, dy, (rm, rv, srm, srv) = span_inputs(cuda, shape, dtype)
    b = shape[0] // ranks
    blocks = [slice(r * b, (r + 1) * b) for r in range(ranks)]
    layouts = [tops.SpanLayout.of(x[i], groups, r, ranks) for r, i in enumerate(blocks)]
    relu, sc = mode != "plain", mode in ("raw_shortcut", "bn_shortcut")
    bn_sc = mode == "bn_shortcut"
    sc_mode = 2 if bn_sc else (1 if sc else 0)
    sums = sum(tops.bn_span_partials(x[i], lay, s[i] if bn_sc else None)
               for i, lay in zip(blocks, layouts))
    fwd = []
    for i, lay in zip(blocks, layouts):
        st = [t.clone() for t in (rm, rv, srm, srv)]
        y, stats = tops.bn_span_apply(
            x[i], sums[0] if bn_sc else sums, st[0], st[1], lay, relu=relu,
            shortcut=s[i] if sc else None, shortcut_sums=sums[1] if bn_sc else None,
            shortcut_running_mean=st[2] if bn_sc else None,
            shortcut_running_var=st[3] if bn_sc else None, update=update)
        fwd.append((y, stats, st))
    kw = [dict(sc_mode=sc_mode, relu=relu, shortcut=s[i] if bn_sc else None,
               y=y if sc_mode == 1 else None) for i, (y, _, _) in zip(blocks, fwd)]
    bsums = sum(tops.bn_span_bwd_partials(x[i], dy[i], stats, lay, **k)
                for i, lay, (_, stats, _), k in zip(blocks, layouts, fwd, kw))
    grads = [tops.bn_span_bwd_apply(x[i], dy[i], stats, bsums, lay, **k)
             for i, lay, (_, stats, _), k in zip(blocks, layouts, fwd, kw)]
    y = torch.cat([f[0] for f in fwd])
    dx = torch.cat([gr[0] for gr in grads])
    ds = torch.cat([gr[1] for gr in grads]) if sc else None
    whole = whole_batch(tops.bn_train, x, s, dy, [rm, rv, srm, srv], groups, mode, update)
    return (y, dx, ds, [f[2] for f in fwd]), whole


def check_span(got, whole, dtype, running=None, outputs=True):
    """got against whole-batch K5: the same relu decisions, y, dx and ds
    (unless ``outputs`` is False) and every block's running statistics
    (against ``running`` where given)."""
    (y, dx, ds, sts), (yw, dxw, dsw, stw) = got, whole
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    same = (y > 0) == (yw > 0)
    assert int((~same).sum()) == 0
    if outputs:
        assert rel(y, yw) <= tol and rel(dx, dxw) <= tol
        if ds is not None:
            assert rel(ds, dsw) <= tol
    for st in sts:
        for a, b in zip(st, stw if running is None else running):
            assert rel(a, b) <= 1e-4


SPAN_MODES = ["plain", "relu", "raw_shortcut", "bn_shortcut"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((12, 24, 9, 5), 1), ((12, 24, 9, 5), 3),
                                          ((12, 24, 9, 5), 2), ((12, 40), 1), ((12, 40), 3),
                                          ((12, 10, 9, 5), 3)])
@pytest.mark.parametrize("mode", SPAN_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_span_mode_matches_whole_batch(cuda, shape, groups, mode, dtype):
    """K5's spanning mode on two halves of a batch (groups that span both,
    misaligned ones at 3 groups, 4-D and 2-D, a channel count that is not
    a multiple of 4) with their partial sums added, against whole-batch K5:
    outputs, gradients and every half's running statistics; a rerun is
    bit-equal."""
    got, whole = span_run(cuda, shape, groups, mode, dtype)
    check_span(got, whole, dtype)
    again = span_run(cuda, shape, groups, mode, dtype)[0]
    for a, b in zip(got[:3], again[:3]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,ranks", [
    ((12, 10, 9, 5), 2, 3),      # C = 10: the direct design on single channels; rank 1 meets both groups
    ((12, 10, 9, 5), 3, 2),      # groups of 4 rows, ranks of 6: offsets in the middle of a group
    ((15, 24, 7, 3), 3, 5),      # groups of 5 over ranks of 3
    ((12, 10), 3, 2),            # a 2-D head input with C = 10
    ((8, 3000), 2, 4),           # a 2-D head wider than 512 16-byte vectors (fp32): channel
                                 # tiles; 4 rows a group
    ((16, 3000), 2, 4),          # the same at 8 rows a group
    ((6, 16, 40, 80), 2, 3)])    # more rows than a CTA's ring holds: several chunks a slab
@pytest.mark.parametrize("mode", SPAN_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("update", [True, False])
def test_bn_span_layouts_and_null_running_statistics(cuda, shape, groups, ranks, mode, dtype,
                                                     update):
    """K5's spanning mode over more layouts (touched > 1, mid-group offsets,
    2-D heads, C = 10, channel tiles, multi-chunk slabs) in every shortcut
    mode, with the running update on and off (null running statistics: left
    as they were), against whole-batch K5; reruns bit-equal. In float32 the
    outputs of both K5 designs are held against the float64 version instead,
    each no further from it than twice the float32 plain version, or 1e-4:
    at a few rows a group the backward's projection of dy cancels in any
    float32 computation, so the two designs may stray from each other by
    more than from float64."""
    got, whole = span_run(cuda, shape, groups, mode, dtype, ranks, update)
    x, s, dy, running = span_inputs(cuda, shape, dtype)
    check_span(got, whole, dtype, running=None if update else running,
               outputs=dtype != torch.float32)
    if not update:
        for a, b in zip(whole[3], running):
            assert torch.equal(a, b)
    if dtype == torch.float32:
        want = whole_batch(bn_train_float64, x.double(), s.double(), dy.double(), running,
                           groups, mode)
        plain = whole_batch(tops.bn_train_reference, x, s, dy, running, groups, mode)
        for name, a, w, p, r in zip(("y", "dx", "ds"), got, whole, plain, want):
            if r is None:
                continue
            tol = max(1e-4, 2 * rel(p, r))
            assert rel(a, r) <= tol, (name, "span", rel(a, r), tol)
            assert rel(w, r) <= tol, (name, "whole-batch K5", rel(w, r), tol)
    again = span_run(cuda, shape, groups, mode, dtype, ranks, update)[0]
    for a, b in zip(got[:3], again[:3]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SPAN_MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_span_autograd_launches_two_kernels_a_direction(cuda, mode, dtype):
    """K5's spanning mode through its autograd entry (``bn_span``, no process
    group: one rank holding the whole batch) against whole-batch K5: two
    launches a direction, counted, and two CUDA kernels a direction in the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    shape, groups = (8, 32, 20, 10), 2
    x, s, dy = (bn_case(cuda, shape, dtype, seed)[0] for seed in (3, 4, 5))
    relu, sc, bn_sc = mode != "plain", mode in ("raw_shortcut", "bn_shortcut"), mode == "bn_shortcut"
    lay = tops.SpanLayout.of(x, groups, 0, 1)
    outs = []
    for fn in ("span", "whole"):
        xi, si = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
        st = [f(shape[1], device=cuda) for f in (torch.zeros, torch.ones) * 2]
        kw = dict(relu=relu, shortcut=si if sc else None,
                  shortcut_running_mean=st[2] if bn_sc else None,
                  shortcut_running_var=st[3] if bn_sc else None)
        if fn == "span":
            before = dict(kernels.BN_TRAIN.fn_launches)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                y = tops.bn_span(xi, st[0], st[1], lay, None, **kw)
                torch.cuda.synchronize()
            fwd_kernels = sum(e.count for e in prof.key_averages()
                              if e.device_type.name == "CUDA" and "span_" in e.key)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                y.backward(dy)
                torch.cuda.synchronize()
            bwd_kernels = sum(e.count for e in prof.key_averages()
                              if e.device_type.name == "CUDA" and "span_" in e.key)
            after = kernels.BN_TRAIN.fn_launches
            assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
                "bn_span_stats": 1, "bn_span_normalize": 1, "bn_span_bwd_reduce": 1,
                "bn_span_bwd_grad": 1}
            assert (fwd_kernels, bwd_kernels) == (2, 2)
        else:
            y = tops.bn_train(xi, st[0], st[1], groups=groups, **kw)
            y.backward(dy)
        outs.append((y.detach(), xi.grad, si.grad if sc else None, st))
    check_span((*outs[0][:3], [outs[0][3]]), outs[1], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,c,split", [(2, 37, 1001, 500), (2, 64, 5994, 2997),
                                         (3, 6, 30000, 12345), (1, 9, 40, 7)])
def test_margin_ce_partial_mode_matches_whole(cuda, k, b, c, split):
    """K6's class-sharded mode on two class ranges (uneven, slab and
    streaming paths) against whole-class K6: the combined loss, correct
    flags (the first index among tied maxima across shards) and lse, and
    each shard's dcos against the whole dcos's columns."""
    from voxsrc2020_speaker_verification_tpu_torch.losses.projections import (
        combine_partials, margin_ce_partial_grad, margin_ce_partials)

    g = torch.Generator(device=cuda).manual_seed(9)
    cos = (torch.rand(k, b, c, generator=g, device=cuda) * 2 - 1) * 0.998
    labels = torch.randint(0, c, (b,), generator=g, device=cuda)
    labels[0], labels[1] = split - 1, split  # labels at both sides of the cut
    dloss = torch.linspace(0.5, 1.5, b, device=cuda)
    ci = cos.clone().requires_grad_(True)
    loss, correct = margin_ce(ci, labels, 32.0, 0.2)
    loss.backward(dloss)
    shards = [(0, cos[:, :, :split].contiguous()), (split, cos[:, :, split:].contiguous())]
    parts = torch.stack([margin_ce_partials(x, labels, 32.0, 0.2, off) for off, x in shards])
    ploss, pcorrect, lse = combine_partials(parts, labels)
    assert rel(ploss, loss.detach()) <= 1e-4 and torch.equal(pcorrect, correct)
    dcos = torch.cat([margin_ce_partial_grad(x, labels, lse, dloss, 32.0, 0.2, off)
                      for off, x in shards], dim=2)
    assert rel(dcos, ci.grad) <= 1e-4


def _thin_artifact(root):
    """An artifact of a thin float32 Res2Net with seeded random weights."""
    from voxsrc2020_speaker_verification_tpu_torch.config import TrainConfig
    from voxsrc2020_speaker_verification_tpu_torch.convert import init_weights
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import save_inference_artifact
    from voxsrc2020_speaker_verification_tpu_torch.models import register_res2net_variant

    model = register_res2net_variant("res2net_thin_kernels_multi", num_filters=(8, 16),
                                     block_sizes=(2, 1), block_strides=(1, 2), width=(8, 16),
                                     split=4, output_dim=16)
    config = TrainConfig(model=model, feat_dim=40, bf16=False)
    weights = init_weights(config, torch.Generator().manual_seed(0))
    return save_inference_artifact(config, weights, str(root / "artifact"))


@pytest.mark.cuda
def test_sharded_embed_two_replicas_on_one_card(cuda, tmp_path):
    """Extraction over [cuda:0, cuda:0] (each bucket batch's rows split in
    two, a replica each) equals one device at the half batch bit for bit,
    and one device at the whole batch within 1e-5."""
    from voxsrc2020_speaker_verification_tpu_torch.eval.export import (
        load_sharded_inference_artifact)
    from voxsrc2020_speaker_verification_tpu_torch.eval.extract import (
        extract_embeddings, make_bucketed_embed_fn)

    artifact = _thin_artifact(tmp_path)
    rng = np.random.RandomState(0)
    feats = [(f"u{i}", rng.randn(t, 40).astype(np.float32))
             for i, t in enumerate([int(rng.randint(30, 900)) for _ in range(19)] + [1000, 1400])]

    def run(devices, batch):
        _, embed = load_sharded_inference_artifact(artifact, devices)
        return extract_embeddings(make_bucketed_embed_fn(embed, batch), iter(feats),
                                  batch_size=batch)

    kernels.reset_launch_counts()
    two = run([cuda, cuda], 32)
    assert all(kernels.launch_counts()[k] > 0 for k in ("split_conv", "bn_act", "stats_pool"))
    half, whole = run([cuda], 16), run([cuda], 32)
    assert sorted(two) == sorted(half) == sorted(u for u, _ in feats)
    for u in half:
        np.testing.assert_array_equal(two[u], half[u], err_msg=u)
        np.testing.assert_allclose(two[u], whole[u], rtol=0, atol=1e-5, err_msg=u)


@pytest.mark.cuda
def test_prepare_stage4_on_k1(cuda, tmp_path):
    """cli.prepare_data stage 4 on the card: K1 launches, and its CM store
    equals the CPU's plain-version store within one CM step (plus K1's
    1e-3)."""
    from voxsrc2020_speaker_verification_tpu_torch.cli import prepare_data
    from voxsrc2020_speaker_verification_tpu_torch.data import audio, kaldi_io

    rng = np.random.RandomState(1)
    for spk in range(2):
        for i in range(3):
            d = tmp_path / "wav" / f"id{spk}" / "v"
            d.mkdir(parents=True, exist_ok=True)
            audio.write_wav(str(d / f"{i}.wav"), (rng.randn(int(rng.randint(8000, 60000)))
                                                  * 2000).astype(np.float32))
    stores = {}
    for dev in ("cuda", "cpu"):
        common = ["--data-root", str(tmp_path / dev), "--dataset", "dev", "--feat-dim", "40",
                  "--num-shards", "2", "--device", dev]
        prepare_data.main(["--stage", "2", "--wav-root", str(tmp_path / "wav"), *common])
        kernels.reset_launch_counts()
        prepare_data.main(["--stage", "4", *common])
        assert (kernels.launch_counts()["fbank"] > 0) == (dev == "cuda")
        stores[dev] = kaldi_io.read_all(kaldi_io.read_mat_scp(
            str(tmp_path / dev / "dev" / "fbank40.scp")))
    lo = min(float(m.min()) for m in stores["cpu"].values())
    hi = max(float(m.max()) for m in stores["cpu"].values())
    step = (hi - lo) / 65535.0 + (hi - lo) / 255.0
    assert sorted(stores["cuda"]) == sorted(stores["cpu"]) and len(stores["cpu"]) == 6
    for u, want in stores["cpu"].items():
        np.testing.assert_allclose(stores["cuda"][u], want, rtol=0, atol=step + 1e-3, err_msg=u)


# ---------------------------------------------------------------------------
# K9 / K9b: the stride-1 split chain in training
# ---------------------------------------------------------------------------

def train_chain_case(cuda, b, width, split, t, f, masked, seed=5):
    """x, weight, the output's cotangent, running statistics and a mask of
    lengths (a row masked down to 3 frames) for one chain."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = split * width
    x = (torch.randn(b, c, t, f, generator=g, device=cuda) * 1.5 + 0.2).contiguous(
        memory_format=torch.channels_last)
    weight = torch.randn((split - 1) * width, width, 3, 3, generator=g, device=cuda) / (9 * width) ** 0.5
    dout = torch.randn(b, c, t, f, generator=g, device=cuda).contiguous(memory_format=torch.channels_last)
    rm = [0.1 * torch.randn(width, generator=g, device=cuda) for _ in range(split - 1)]
    rv = [0.5 + torch.rand(width, generator=g, device=cuda) for _ in range(split - 1)]
    mask = None
    if masked:
        lens = torch.tensor([t if i % 2 == 0 else max(1, (t * i) // b) for i in range(b)], device=cuda)
        lens[-1] = 3
        mask = (torch.arange(t, device=cuda)[None] < lens[:, None]).float()
    return x, weight, dout, rm, rv, mask


def train_chain_run(fn, x, weight, dout, rm, rv, groups, mask, dtype, **kw):
    """fn's output, dx, dW and updated running statistics (copies), in
    ``dtype``."""
    xi = x.to(dtype).detach().clone().requires_grad_(True)
    wi = weight.to(dtype).detach().clone().requires_grad_(True)
    st = torch.float64 if dtype == torch.float64 else torch.float32
    rmc, rvc = [r.to(st).clone() for r in rm], [r.to(st).clone() for r in rv]
    y = fn(xi, wi, rmc, rvc, groups, mask, **kw)
    y.backward(dout.to(dtype))
    return [y.detach(), xi.grad, wi.grad] + rmc + rvc


def chain_errors(got, want):
    """Relative error (to each tensor's largest magnitude) of out, dx, dW
    and of the running statistics (the largest over groups)."""
    errs = [rel(a, b) for a, b in zip(got[:3], want[:3])]
    return errs + [max(rel(a, b) for a, b in zip(got[3:], want[3:]))]


def float64_on_decisions(run, case, groups, mask, width, split):
    """The plain chain in float64 on ``run``'s relu decisions (its output
    > 0 in each group's slice; a decision at a value within rounding of
    zero may go either way, and moves the gradient there by the whole
    upstream value): (its results, the largest |float64 pre-relu value|
    where the decision went the other way)."""
    import functools

    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    masks = [run[0][:, i * width: (i + 1) * width] > 0 for i in range(split - 1)]
    pre = []
    ref = train_chain_run(functools.partial(trn.split_chain_train_reference, relu_masks=masks,
                                            pre_relu=pre), *case, groups, mask, torch.float64)
    worst = max((float(v[m != (v > 0)].abs().max()) for v, m in zip(pre, masks)
                 if (m != (v > 0)).any()), default=0.0)
    return ref, worst


# (w, s); 32-192: the Hopper design in bf16; 12: bf16 on FMA
TRAIN_WIDTHS = [(8, 6), (16, 6), (24, 4), (32, 6), (48, 4), (64, 4), (96, 4), (192, 4), (12, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,split", TRAIN_WIDTHS)
@pytest.mark.parametrize("groups,masked", [(1, False), (2, True), (8, False), (8, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_train_kernels_match_plain(cuda, width, split, groups, masked, dtype):
    """K9 / K9b against split_chain_train's plain version in float64 on the
    run's own relu decisions (F = 21: two ragged 11-wide F tiles; T = 13; 8
    samples, one a BN group at 8 groups; w = 12 takes the FMA variant in
    bfloat16 too): output, dx, dW and the running
    statistics. bfloat16: on the bf16 inputs, 5e-2 relative to each
    tensor's largest magnitude (K2's tolerance for a chain), the running
    statistics 2e-2 (K5's), decisions that went the other way within 2^-5
    of zero; float32: within twice the float32 plain version's own error
    (against float64 on its decisions) or 1e-4, decisions that went the
    other way within 1e-4 of zero. s launches forward and s backward (one
    statistics launch, one grad launch a group), no K5."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    case = train_chain_case(cuda, 8, width, split, 13, 21, masked)
    if dtype == torch.bfloat16:
        case = tuple(t.bfloat16() for t in case[:3]) + case[3:]
    before = kernels.function_launch_counts()
    got = train_chain_run(trn.split_chain_train, *case[:5], groups, case[5], dtype)
    torch.cuda.synchronize()
    after = kernels.function_launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert launched == {"split_train.split_train_fwd": split - 1,
                        "split_train.split_train_finish": 1,
                        "split_train.split_train_bwd_stats": 1,
                        "split_train.split_train_bwd_grad": split - 1}
    assert all(torch.isfinite(t.float()).all() for t in got)
    ref, tie = float64_on_decisions(got, case[:5], groups, case[5], width, split)
    errs = chain_errors(got, ref)
    if dtype == torch.bfloat16:
        assert max(errs[:3]) <= 5e-2 and errs[3] <= 2e-2 and tie <= 2 ** -5, (errs, tie)
    else:
        plain = train_chain_run(trn.split_chain_train_reference, *case[:5], groups, case[5],
                                torch.float32)
        pref, ptie = float64_on_decisions(plain, case[:5], groups, case[5], width, split)
        perrs = chain_errors(plain, pref)
        assert all(e <= max(1e-4, 2 * p) for e, p in zip(errs, perrs)), (errs, perrs)
        assert max(tie, ptie) <= 1e-4, (tie, ptie)


@pytest.mark.cuda
@pytest.mark.parametrize("width,split,t,f", [(16, 6, 40, 20), (64, 4, 25, 10), (24, 4, 9, 80),
                                             (96, 4, 25, 10)])
def test_split_train_kernels_rerun_bit_for_bit(cuda, width, split, t, f):
    """Two runs of K9 / K9b on the same inputs (bfloat16, masked, 2 BN
    groups) agree bit for bit: output, dx, dW and running statistics (fixed
    summation orders, no float atomics)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    case = train_chain_case(cuda, 4, width, split, t, f, True, seed=9)
    runs = [train_chain_run(trn.split_chain_train, *case[:5], 2, case[5], torch.bfloat16)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_split_train_span_route_under_a_two_rank_mesh(cuda):
    """Under a mesh of two data ranks, bn_groups 1 spans both ranks: the
    chain takes the "span" route (F.conv2d + K5's spanning mode), counted,
    and launches no K9; bn_groups 2 lies inside each rank: K9 / K9b with one
    group here, equal to the plain version at one group."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn
    from voxsrc2020_speaker_verification_tpu_torch.parallel import sharding

    x, weight, dout, rm, rv, _ = train_chain_case(cuda, 4, 16, 4, 12, 10, False)
    mesh = sharding.Mesh(num_data=2)
    for groups, route in ((1, "span"), (2, "kernels")):
        trn.reset_split_train_routes()
        before = kernels.function_launch_counts()
        with sharding.active(mesh):
            got = train_chain_run(trn.split_chain_train, x, weight, dout, rm, rv, groups, None,
                                  torch.bfloat16)
        after = kernels.function_launch_counts()
        k9 = sum(after[k] - before[k] for k in after if k.startswith("split_train."))
        span = sum(after[k] - before[k] for k in after if k.startswith("bn_train.bn_span"))
        assert trn.split_train_route_counts() == {"kernels": int(route == "kernels"),
                                                  "span": int(route == "span"), "plain": 0}
        assert (k9 > 0, span > 0) == (route == "kernels", route == "span")
    case = (x.bfloat16(), weight.bfloat16(), dout.bfloat16(), rm, rv)
    want, tie = float64_on_decisions(got, case, 1, None, 16, 4)
    errs = chain_errors(got, want)
    assert max(errs[:3]) <= 5e-2 and errs[3] <= 2e-2 and tie <= 2 ** -5, (errs, tie)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "nothing_saveable", "dots_saveable", "checkpoint_dots"])
def test_split_train_remat_launches_by_policy(cuda, policy):
    """A rematerialized bottleneck block in training: under None and
    nothing_saveable the recompute runs K9 again (s launches) with the
    running update off; under dots_saveable and checkpoint_dots it takes
    K9's outputs from the first forward (no launch). Either way the running
    statistics and the output equal the block's without remat bit for bit,
    and the gradients within 1e-2 (cuDNN's conv1 / conv3 gradients need not
    rerun bit for bit)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    torch.manual_seed(4)
    block = trn.BottleneckBlockV1(24, 6, 1, True, 4, 8).to(cuda)
    for p in block.parameters():
        p.data.normal_(0.0, 0.3)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 24, 20, 10, generator=g, device=cuda).bfloat16().contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(4, 24, 20, 10, generator=g, device=cuda).bfloat16()
    state = {k: v.clone() for k, v in block.state_dict().items()}
    results = []
    for remat in (False, True):
        block.load_state_dict(state)
        xi = x.clone().requires_grad_(True)
        before = kernels.function_launch_counts()
        if remat:
            y = trn.remat_block(block, xi, True, None, None, trn.remat_context(policy))
        else:
            y = block(xi, True)
        y.backward(dy)
        torch.cuda.synchronize()
        after = kernels.function_launch_counts()
        fwd = sum(after[k] - before[k] for k in ("split_train.split_train_fwd",
                                                 "split_train.split_train_finish"))
        results.append((fwd, y.detach(), xi.grad, [p.grad.clone() for p in block.parameters()],
                        {k: v.clone() for k, v in block.state_dict().items()}))
        block.zero_grad()
    (f0, y0, dx0, g0, s0), (f1, y1, dx1, g1, s1) = results
    assert f0 == 4
    assert f1 == (4 if policy in ("dots_saveable", "checkpoint_dots") else 8)
    assert torch.equal(y0, y1) and rel(dx1, dx0) <= 1e-2
    assert all(rel(b, a) <= 1e-2 for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


# ---------------------------------------------------------------------------
# K11 / K11b: the stride-2 split stage in training
# ---------------------------------------------------------------------------

def stride2_train_case(cuda, b, width, split, t, f, seed=6):
    """x, weight, the output's cotangent and running statistics for one
    stride-2 stage in training."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = split * width
    x = (torch.randn(b, c, t, f, generator=g, device=cuda) * 1.5 + 0.2).contiguous(
        memory_format=torch.channels_last)
    weight = torch.randn((split - 1) * width, width, 3, 3, generator=g, device=cuda) / (9 * width) ** 0.5
    dout = torch.randn(b, c, (t - 1) // 2 + 1, (f - 1) // 2 + 1, generator=g,
                       device=cuda).contiguous(memory_format=torch.channels_last)
    rm = [0.1 * torch.randn(width, generator=g, device=cuda) for _ in range(split - 1)]
    rv = [0.5 + torch.rand(width, generator=g, device=cuda) for _ in range(split - 1)]
    return x, weight, dout, rm, rv


def stride2_train_run(fn, x, weight, dout, rm, rv, groups, dtype, **kw):
    """fn's output, dx, dW and updated running statistics (copies), in
    ``dtype``."""
    xi = x.to(dtype).detach().clone().requires_grad_(True)
    wi = weight.to(dtype).detach().clone().requires_grad_(True)
    st = torch.float64 if dtype == torch.float64 else torch.float32
    rmc, rvc = [r.to(st).clone() for r in rm], [r.to(st).clone() for r in rv]
    y = fn(xi, wi, rmc, rvc, groups, **kw)
    y.backward(dout.to(dtype))
    return [y.detach(), xi.grad, wi.grad] + rmc + rvc


def stride2_float64_on_decisions(run, case, groups, width, split):
    """The plain stage in float64 on ``run``'s relu decisions (as K9's
    relu_masks): (its results, the largest |float64 pre-relu value| where
    the decision went the other way)."""
    import functools

    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    masks = [run[0][:, i * width: (i + 1) * width] > 0 for i in range(split - 1)]
    pre = []
    ref = stride2_train_run(functools.partial(trn.split_stride2_train_reference,
                                              relu_masks=masks, pre_relu=pre),
                            *case, groups, torch.float64)
    worst = max((float(v[m != (v > 0)].abs().max()) for v, m in zip(pre, masks)
                 if (m != (v > 0)).any()), default=0.0)
    return ref, worst


# (w, s, T, F): the registered stride-2 widths (16-64 at the bench's s = 6,
# 48-192 at s = 4), the thin variants' 8, and widths on the FMA design in
# bf16 too (24, 5); odd and even T and F
STRIDE2_TRAIN_WIDTHS = [(8, 4, 17, 10), (16, 6, 40, 21), (32, 6, 25, 19), (48, 4, 33, 20),
                        (64, 6, 26, 20), (96, 4, 40, 20), (192, 4, 50, 20), (24, 4, 17, 9),
                        (5, 4, 15, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,split,t,f", STRIDE2_TRAIN_WIDTHS, ids=str)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_stride2_train_kernels_match_plain(cuda, width, split, t, f, groups, dtype):
    """K11 / K11b on stride2_train_plan's own pick (over these widths: mma
    with the weights whole, in slices, in slices with input chunks, FMA in
    bf16, FMA in float32; test_stride2_train_widths_cover_every_design) against
    split_stride2_train's plain version in float64 on the run's own relu
    decisions: output, dx, dW and the running statistics. bfloat16 on the
    bf16 inputs within 5e-2 of each tensor's largest magnitude (K2's
    tolerance), the statistics within 2e-2 (K5's), decisions that went the
    other way within 2^-5 of zero; float32 within twice the float32 plain
    version's own error or 1e-4. The tail bit-equal to the plain version's
    average pool in the same dtype; a rerun bit for bit (dW's splits added
    in a fixed order); two launches forward and two backward."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    case = stride2_train_case(cuda, 4, width, split, t, f)
    if dtype == torch.bfloat16:
        case = tuple(v.bfloat16() for v in case[:3]) + case[3:]
    before = kernels.function_launch_counts()
    got = stride2_train_run(trn.split_stride2_train, *case, groups, dtype)
    torch.cuda.synchronize()
    after = kernels.function_launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert launched == {f"split_stride2_train.split_stride2_train_{fn}": 1
                        for fn in ("fwd", "finish", "bwd_stats", "bwd_grad")}
    tail = slice((split - 1) * width, None)
    plain = stride2_train_run(trn.split_stride2_train_reference, *case, groups, dtype)
    assert all(torch.isfinite(v.float()).all() for v in got)
    assert torch.equal(got[0][:, tail], plain[0][:, tail])
    assert all(torch.equal(a, b) for a, b in zip(got, stride2_train_run(
        trn.split_stride2_train, *case, groups, dtype)))
    ref, tie = stride2_float64_on_decisions(got, case, groups, width, split)
    errs = chain_errors(got, ref)
    if dtype == torch.bfloat16:
        assert max(errs[:3]) <= 5e-2 and errs[3] <= 2e-2 and tie <= 2 ** -5, (errs, tie)
    else:
        pref, ptie = stride2_float64_on_decisions(plain, case, groups, width, split)
        perrs = chain_errors(plain, pref)
        assert all(e <= max(1e-4, 2 * p) for e, p in zip(errs, perrs)), (errs, perrs)
        assert max(tie, ptie) <= 1e-4, (tie, ptie)


def test_stride2_train_widths_cover_every_design():
    """The card test's widths reach every path stride2_train_plan picks: mma
    with a group's weights whole in each CTA (forward and dgrad), mma with
    the forward's output channels in slices and dx's in 16-channel dgrad
    slices (w = 96), the same with the forward's stages in input-channel
    chunks (w = 192), FMA in bfloat16 and FMA in float32."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    picked = set()
    for width, split, t, f in STRIDE2_TRAIN_WIDTHS:
        for groups in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                plan = trn.stride2_train_plan(width, split, (4, split * width, t, f), groups,
                                              dtype)
                picked.add((plan["design"], plan["nsl"], plan["nkc"], plan["nds"], dtype))
    assert picked == {("mma", 1, 1, 1, torch.bfloat16), ("mma", 2, 1, 6, torch.bfloat16),
                      ("mma", 4, 4, 12, torch.bfloat16), ("fma", 0, 0, 0, torch.bfloat16),
                      ("fma", 0, 0, 0, torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_stride2_train_running_update(cuda, dtype):
    """K11's running update equals the plain version's (momentum, Bessel
    over the output's rows of a BN group, the mean over groups) within
    float32 rounding, and leaves the statistics alone inside
    ops.running_update(False), the output unchanged."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn
    from voxsrc2020_speaker_verification_tpu_torch.ops import nn as ops

    x, weight, _, rm, rv = stride2_train_case(cuda, 8, 32, 6, 25, 19)
    x, weight = x.to(dtype), weight.to(dtype)
    with torch.no_grad():
        runs = []
        for fn in (trn.split_stride2_train, trn.split_stride2_train_reference):
            rmc, rvc = [r.clone() for r in rm], [r.clone() for r in rv]
            runs.append((fn(x, weight, rmc, rvc, 4), rmc, rvc))
        (y, km, kv), (_, pm, pv) = runs
        for a, b in zip(km + kv, pm + pv):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), (a, b)
        rmc, rvc = [r.clone() for r in rm], [r.clone() for r in rv]
        with ops.running_update(False):
            y2 = trn.split_stride2_train(x, weight, rmc, rvc, 4)
        assert all(torch.equal(a, b) for a, b in zip(rmc + rvc, rm + rv))
        assert torch.equal(y, y2)


@pytest.mark.cuda
def test_split_stride2_train_stage_launches_nothing_of_the_route(cuda, monkeypatch):
    """Res2NetSplitConv(strides=2) in training on a CUDA tensor: K11 / K11b
    alone, two launches each way, route "train_kernels"; no F.conv2d, K5,
    average pool, padded copy or torch.cat (all refused while it runs), no
    K10; its running statistics updated in place."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as rn

    stage = rn.Res2NetSplitConv(6, 16, 2).to(cuda)
    with torch.no_grad():
        stage.weight.normal_(0, 0.05)
    x, _, dout, _, _ = stride2_train_case(cuda, 4, 16, 6, 40, 21)
    xb = x.bfloat16().requires_grad_(True)
    means = [bn.running_mean.clone() for bn in stage._bns()]

    def refuse(*a, **k):
        raise AssertionError("the training stage ran a step of the replaced route")

    before = (kernels.function_launch_counts(), rn.split_stride2_route_counts())
    with monkeypatch.context() as m:
        for mod, name in ((rn.F, "conv2d"), (rn.ops, "avg_pool_3x3"), (rn.ops, "bn_train"),
                          (rn.ops, "fixed_padding"), (torch, "cat")):
            m.setattr(mod, name, refuse)
        y = stage(xb, True)
        y.backward(dout.bfloat16())
        torch.cuda.synchronize()
    after, routes = kernels.function_launch_counts(), rn.split_stride2_route_counts()
    launched = {k: after[k] - before[0][k] for k in after if after[k] != before[0][k]}
    assert launched == {f"split_stride2_train.split_stride2_train_{fn}": 1
                        for fn in ("fwd", "finish", "bwd_stats", "bwd_grad")}
    assert routes["train_kernels"] - before[1]["train_kernels"] == 1
    assert xb.grad is not None and stage.weight.grad is not None
    assert all(not torch.equal(bn.running_mean, m0) for bn, m0 in zip(stage._bns(), means))


@pytest.mark.cuda
def test_split_stride2_train_span_route_under_a_two_rank_mesh(cuda):
    """Under a mesh of two data ranks, bn_groups 1 spans both ranks: the
    stage takes the "span" route (cuDNN's grouped conv + K5's spanning
    mode), counted, and launches no K11; bn_groups 2 lies inside each rank:
    K11 / K11b with one group here, equal to the plain version at one
    group."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn
    from voxsrc2020_speaker_verification_tpu_torch.parallel import sharding

    x, weight, dout, rm, rv = stride2_train_case(cuda, 4, 16, 4, 12, 10)
    mesh = sharding.Mesh(num_data=2)
    for groups, route in ((1, "span"), (2, "train_kernels")):
        r0 = trn.split_stride2_route_counts()
        before = kernels.function_launch_counts()
        with sharding.active(mesh):
            got = stride2_train_run(trn.split_stride2_train, x, weight, dout, rm, rv, groups,
                                    torch.bfloat16)
        after = kernels.function_launch_counts()
        r1 = trn.split_stride2_route_counts()
        k11 = sum(after[k] - before[k] for k in after if k.startswith("split_stride2_train."))
        span = sum(after[k] - before[k] for k in after if k.startswith("bn_train.bn_span"))
        assert {k: r1[k] - r0[k] for k in r1 if r1[k] != r0[k]} == {route: 1}
        assert (k11 > 0, span > 0) == (route == "train_kernels", route == "span")
    case = (x.bfloat16(), weight.bfloat16(), dout.bfloat16(), rm, rv)
    want, tie = stride2_float64_on_decisions(got, case, 1, 16, 4)
    errs = chain_errors(got, want)
    assert max(errs[:3]) <= 5e-2 and errs[3] <= 2e-2 and tie <= 2 ** -5, (errs, tie)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "nothing_saveable", "dots_saveable", "checkpoint_dots"])
def test_split_stride2_train_remat_launches_by_policy(cuda, policy):
    """A rematerialized stride-2 bottleneck block in training: under None
    and nothing_saveable the recompute runs K11 again (its two forward
    launches) with the running update off; under dots_saveable and
    checkpoint_dots it takes K11's outputs from the first forward (the
    operator runs once a block). Either way the running statistics and the
    output equal the block's without remat bit for bit, the gradients
    within 1e-2 (cuDNN's conv1 / conv3 gradients need not rerun bit for
    bit)."""
    from voxsrc2020_speaker_verification_tpu_torch.models import res2net as trn

    torch.manual_seed(4)
    block = trn.BottleneckBlockV1(24, 16, 2, True, 4, 16).to(cuda)
    for p in block.parameters():
        p.data.normal_(0.0, 0.3)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 24, 20, 11, generator=g, device=cuda).bfloat16().contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(4, 64, 10, 6, generator=g, device=cuda).bfloat16()
    state = {k: v.clone() for k, v in block.state_dict().items()}
    results = []
    for remat in (False, True):
        block.load_state_dict(state)
        xi = x.clone().requires_grad_(True)
        before = kernels.function_launch_counts()
        if remat:
            y = trn.remat_block(block, xi, True, None, None, trn.remat_context(policy))
        else:
            y = block(xi, True)
        y.backward(dy)
        torch.cuda.synchronize()
        after = kernels.function_launch_counts()
        fwd = sum(after[k] - before[k] for k in ("split_stride2_train.split_stride2_train_fwd",
                                                 "split_stride2_train.split_stride2_train_finish"))
        results.append((fwd, y.detach(), xi.grad, [p.grad.clone() for p in block.parameters()],
                        {k: v.clone() for k, v in block.state_dict().items()}))
        block.zero_grad()
    (f0, y0, dx0, g0, s0), (f1, y1, dx1, g1, s1) = results
    assert f0 == 2
    assert f1 == (2 if policy in ("dots_saveable", "checkpoint_dots") else 4)
    assert torch.equal(y0, y1) and rel(dx1, dx0) <= 1e-2
    assert all(rel(b, a) <= 1e-2 for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
