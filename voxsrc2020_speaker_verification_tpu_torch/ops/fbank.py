"""Kaldi-compatible log-mel FBANK: numpy constants, a plain PyTorch version
and the CUDA kernel K1 (``csrc/fbank.cu``).

Numerically this is Kaldi ``compute-fbank-feats`` with the reference configs
(16 kHz, 25 ms window, 10 ms shift, preemphasis 0.97, remove-DC, Povey
window, 512-point FFT, snip-edges, mel 20 Hz to Nyquist, log floored at
FLT_EPSILON). Dither (Kaldi's ``dither * N(0, 1)`` added to every framed
sample) takes the draws as an explicit tensor, so the kernel and its plain
version see the same numbers.

Every per-frame step before the power spectrum is linear in the frame, so it
folds into two constant matrices A, B of shape (frame_length, num_fft_bins):

    power[k] = (x @ A)[k]^2 + (x @ B)[k]^2
    fbank    = log(max(power @ M, FLT_EPSILON))

Waveforms are float32 in int16 scale (-32768..32767), as Kaldi reads PCM.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import FBANK, KernelError, check_cuda, ptr, stream_scratch

# std::numeric_limits<float>::epsilon() -- Kaldi's mel-energy floor.
FLT_EPSILON = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0: offset from Nyquist
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    snip_edges: bool = True
    use_power: bool = True
    use_log_fbank: bool = True

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * 0.001 * self.frame_length_ms)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * 0.001 * self.frame_shift_ms)

    @property
    def padded_frame_length(self) -> int:
        if not self.round_to_power_of_two:
            return self.frame_length
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def num_frames(num_samples: int, cfg: FbankConfig) -> int:
    """Kaldi snip-edges frame count: 0 if fewer samples than one window."""
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def feature_window(cfg: FbankConfig) -> np.ndarray:
    """Kaldi window functions (feature-window.cc FeatureWindowFunction)."""
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window_type == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if cfg.window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if cfg.window_type == "rectangular":
        return np.ones(n)
    if cfg.window_type == "blackman":
        return 0.42 - 0.5 * np.cos(a * i) + 0.08 * np.cos(2 * a * i)
    raise ValueError(f"unknown window type {cfg.window_type}")


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Dense (num_fft_bins, num_bins) triangular mel filter matrix (Kaldi
    MelBanks: Nyquist bin excluded, centers equally spaced in mel)."""
    padded = cfg.padded_frame_length
    num_fft_bins = padded // 2
    nyquist = 0.5 * cfg.sample_rate
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    if not 0 <= cfg.low_freq < high_freq <= nyquist:
        raise ValueError(f"bad mel range [{cfg.low_freq}, {high_freq}]")

    fft_bin_width = cfg.sample_rate / padded
    mel_low = mel_scale(cfg.low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_bins + 1)

    fft_freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)
    mel = mel_scale(fft_freqs)[:, None]

    bins = np.arange(cfg.num_bins, dtype=np.float64)[None, :]
    left = mel_low + bins * mel_delta
    center = mel_low + (bins + 1) * mel_delta
    right = mel_low + (bins + 2) * mel_delta

    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    weights = np.where((mel > left) & (mel <= center), up, 0.0)
    weights = np.where((mel > center) & (mel < right), down, weights)
    return weights


@lru_cache(maxsize=8)
def analysis_matrices(cfg: FbankConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, B, M): real/imag analysis matrices (frame_length, num_fft_bins)
    with remove-DC, preemphasis, window and the real DFT folded in, and the
    mel matrix (num_fft_bins, num_bins). Built in float64, returned float32."""
    n = cfg.frame_length
    padded = cfg.padded_frame_length
    num_fft_bins = padded // 2

    t = np.eye(n, dtype=np.float64)
    if cfg.remove_dc_offset:
        t = t - np.full((n, n), 1.0 / n)
    if cfg.preemph_coeff != 0.0:
        # y[i] = x[i] - p * x[i-1]; y[0] = x[0] - p * x[0]
        p = np.eye(n, dtype=np.float64)
        p[0, 0] = 1.0 - cfg.preemph_coeff
        p[np.arange(1, n), np.arange(0, n - 1)] = -cfg.preemph_coeff
        t = p @ t
    t = feature_window(cfg)[:, None] * t

    k = np.arange(num_fft_bins, dtype=np.float64)[None, :]
    nn = np.arange(n, dtype=np.float64)[:, None]
    angle = 2.0 * math.pi * nn * k / padded
    a = t.T @ np.cos(angle)
    b = t.T @ (-np.sin(angle))
    m = mel_banks(cfg)
    return (a.astype(np.float32), b.astype(np.float32), m.astype(np.float32))


@lru_cache(maxsize=8)
def _device_matrices(cfg: FbankConfig, device: torch.device):
    return tuple(torch.from_numpy(x).to(device) for x in analysis_matrices(cfg))


def mel_columns(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mel matrix (num_fft_bins, num_bins) by columns, as K1 reads it:
    column c's weights over the run of FFT bins from its first to its last
    nonzero, ``weights[offsets[c]:offsets[c + 1]]`` for bins ``starts[c]``
    on (an all-zero column has an empty run)."""
    starts, runs = [], []
    for col in m.T:
        nz = np.flatnonzero(col)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        starts.append(lo)
        runs.append(col[lo:hi])
    offsets = np.cumsum([0] + [len(r) for r in runs])
    weights = np.concatenate(runs) if runs else np.zeros(0)
    return (np.asarray(starts, np.int32), offsets.astype(np.int32),
            weights.astype(np.float32))


@lru_cache(maxsize=8)
def _device_mel_columns(cfg: FbankConfig, device: torch.device):
    return tuple(torch.from_numpy(x).to(device)
                 for x in mel_columns(analysis_matrices(cfg)[2]))


def pcm16(w: np.ndarray) -> np.ndarray:
    """Quantize float samples to the int16 grid (round half to even, clip)."""
    return np.clip(np.rint(w), -32768, 32767)


def _check_noise(noise: torch.Tensor, waves: torch.Tensor, cfg: FbankConfig) -> None:
    want = (waves.shape[0], num_frames(waves.shape[1], cfg), cfg.frame_length)
    if tuple(noise.shape) != want or noise.dtype != torch.float32:
        raise ValueError(f"dither noise must be float32 {want}, got {noise.dtype} "
                         f"{tuple(noise.shape)}")
    if noise.device != waves.device:
        raise ValueError(f"dither noise on {noise.device}, waves on {waves.device}")
    if cfg.dither == 0.0:
        raise ValueError("dither noise given with cfg.dither == 0")


def draw_noise(batch: int, num_samples: int, cfg: FbankConfig, generator: torch.Generator,
               device) -> torch.Tensor:
    """Dither draws for :func:`fbank`: N(0, 1) of shape (batch, T,
    frame_length), T = num_frames(num_samples), from ``generator``."""
    return torch.randn((batch, num_frames(num_samples, cfg), cfg.frame_length),
                       generator=generator, device=device)


def fbank_reference(waves: torch.Tensor, cfg: FbankConfig,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch FBANK: (B, S) float32 -> (B, T, num_bins), T =
    num_frames(S). Frames by ``unfold`` and three float32 matmuls; with
    ``noise`` (B, T, frame_length) float32, ``cfg.dither * noise`` is added
    to the frames first (the JAX package's dither)."""
    a, b, m = _device_matrices(cfg, waves.device)
    t = num_frames(waves.shape[1], cfg)
    if noise is not None:
        _check_noise(noise, waves, cfg)
    if t == 0:
        return waves.new_zeros((waves.shape[0], 0, cfg.num_bins))
    frames = waves.float().unfold(1, cfg.frame_length, cfg.frame_shift)[:, :t]
    if noise is not None:
        frames = frames + cfg.dither * noise
    re = frames @ a
    im = frames @ b
    power = re * re + im * im
    if not cfg.use_power:
        power = torch.sqrt(power)
    mel = power @ m
    if cfg.use_log_fbank:
        mel = torch.log(torch.clamp(mel, min=FLT_EPSILON))
    return mel


def fbank(waves: torch.Tensor, cfg: FbankConfig = FbankConfig(dither=0.0),
          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched log-mel FBANK: (B, S) or (S,) float32 int16-scale -> (B, T,
    num_bins) or (T, num_bins).

    Without ``noise`` dither is off and ``cfg.dither`` must be 0. With
    ``noise``, float32 draws of shape (B, T, frame_length) (the caller's
    ``torch.randn`` on its own generator; :func:`draw_noise` makes them),
    ``cfg.dither`` must be nonzero and ``cfg.dither * noise`` is added to
    the framed samples (K1 takes them contiguous).

    On a CUDA tensor this launches K1 (``csrc/fbank.cu``; its dithered
    variant with noise) in the design :func:`kernel_route` names: the fast
    one reads the mel matrix by columns (:func:`mel_columns`), 128 columns a
    pass (one pass for the 40- and 80-bin banks); the general one takes the
    shapes the fast one does not. On a CPU tensor it runs
    :func:`fbank_reference`. Padded
    samples past an utterance's end give frames to be masked downstream.
    """
    if noise is None and cfg.dither != 0.0:
        raise ValueError("fbank without dither noise runs with cfg.dither=0; pass the "
                         "draws as noise (B, T, frame_length) to dither")
    if waves.ndim == 1:
        return fbank(waves[None], cfg, None if noise is None else noise[None])[0]
    if noise is not None:
        _check_noise(noise, waves, cfg)
    if waves.device.type == "cpu":
        return fbank_reference(waves, cfg, noise)

    check_cuda("fbank", waves, (torch.float32,), 2)
    if noise is not None:
        check_cuda("fbank noise", noise, (torch.float32,), 3)
    batch, num_samples = waves.shape
    t = num_frames(num_samples, cfg)
    out = torch.empty((batch, t, cfg.num_bins), dtype=torch.float32,
                      device=waves.device)
    if t == 0 or batch == 0:
        return out
    a, b, _ = _device_matrices(cfg, waves.device)
    starts, offsets, weights = _device_mel_columns(cfg, waves.device)
    path = "plain" if noise is None else "dither"
    if kernel_route(cfg) == "general":
        plan = general_plan(cfg, batch, t, noise is not None)
        cols = _device_tile_columns(cfg, waves.device)
        part = torch.empty(plan["part_floats"], dtype=torch.float32, device=waves.device)
        tickets = stream_scratch(waves.device, "fbank_general_tickets", plan["tickets"],
                                 torch.int32)
        FBANK.launch(
            "fbank_general_f32", waves.device, ptr(waves), ptr(a), ptr(b), ptr(starts),
            ptr(offsets), ptr(weights), ptr(cols), ptr(out), ptr(part), part.numel(),
            ptr(tickets), tickets.numel(), batch, num_samples, t, cfg.frame_length, cfg.frame_shift, a.shape[1], cfg.num_bins,
            int(cfg.use_power), int(cfg.use_log_fbank), FLT_EPSILON, ptr(noise),
            float(cfg.dither), plan["smem"], path=path)
        return out
    FBANK.launch(
        "fbank_f32", waves.device, ptr(waves), ptr(a), ptr(b), ptr(starts), ptr(offsets),
        ptr(weights), ptr(out), batch, num_samples, t, cfg.frame_length, cfg.frame_shift,
        a.shape[1], cfg.num_bins, weights.numel(), int(cfg.use_power),
        int(cfg.use_log_fbank), FLT_EPSILON, ptr(noise), float(cfg.dither), path=path)
    return out


# The fast design's limits (csrc/fbank.cu: fbank_f32 refuses the rest): FFT
# bins (kSplit * kBins, a multiple of 4), packed mel weights (kMelCap), frame
# length and shift, and its shared-memory layout (Layout) under the 227 KB a
# CTA can take, less 2 KB for the static arrays.
_FAST_BINS, _FAST_MEL_CAP, _FAST_FRAME_MAX = 256, 1024, 4096
_FAST_SMEM_LIMIT = 227 * 1024 - 2048


def fast_smem_bytes(frame_length: int, frame_shift: int) -> int:
    """Shared memory of the fast design's CTA, csrc/fbank.cu's Layout: the
    A/B slice (rows padded to 8 warps x 64 floats), two padded sample
    buffers of a 32-frame tile, the warps' partial sums, two power buffers
    and the packed mel weights."""
    kpad = -(-frame_length // 8) * 8
    n = 31 * frame_shift + kpad
    seg = (n + 4 * -(-n // frame_shift) + 3) & ~3
    return 4 * (kpad * 64 + 2 * seg + 8 * 64 * 32 + 2 * 4 * 256 + _FAST_MEL_CAP)


@lru_cache(maxsize=32)
def kernel_route(cfg: FbankConfig) -> str:
    """K1's design for a config: ``"fast"`` (persistent clusters that keep
    the analysis matrices on chip) where its limits hold, else
    ``"general"`` (``fbank_general_f32``: 64-frame x 64-bin register tiles,
    :func:`general_plan`), which takes every shape this module computes:
    more than 256 FFT bins (a padded frame over 512 samples: 32 kHz, or a
    frame over 32 ms at 16 kHz), more than 1024 packed mel weights, a frame
    length or shift over 4096, or a layout over the fast design's shared
    memory."""
    nfft = cfg.padded_frame_length // 2
    nnz = mel_columns(analysis_matrices(cfg)[2])[2].size
    fast = (nfft <= _FAST_BINS and nfft % 4 == 0 and nnz <= _FAST_MEL_CAP
            and cfg.frame_length <= _FAST_FRAME_MAX and cfg.frame_shift <= _FAST_FRAME_MAX
            and fast_smem_bytes(cfg.frame_length, cfg.frame_shift) <= _FAST_SMEM_LIMIT)
    return "fast" if fast else "general"


def kernel_plan(cfg: FbankConfig = FbankConfig(dither=0.0), device=None) -> dict:
    """K1's launch plan on the card, as its C source decides it: the
    persistent clusters the card holds at once (each walks 32-frame tiles)
    and the shared memory a CTA takes. For reports; a launch needs none of
    it."""
    device = torch.device("cuda" if device is None else device)
    lib = FBANK.load()
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.fbank_plan(cfg.frame_length, cfg.frame_shift, ctypes.byref(clusters),
                              ctypes.byref(smem))
    if code != 0:
        raise KernelError(f"fbank.fbank_plan: CUDA error {code} "
                          f"({lib.vsv_error_string(code).decode()})")
    return {"clusters": clusters.value, "smem_bytes": smem.value}


# The general path's tiles (csrc/fbank.cu: kGen*): frames and FFT bins a
# CTA, samples a staged chunk, chunks in the ring, threads, and the floats
# of a staged frame row (a chunk and 4 of padding)
_GEN_FRAMES, _GEN_BINS, _GEN_K, _GEN_STAGES, _GEN_THREADS = 64, 64, 32, 3, 256
_GEN_XS = _GEN_K + 4


@lru_cache(maxsize=32)
def general_tile_columns(cfg: FbankConfig) -> np.ndarray:
    """(bin tiles, 2) int32: for each 64-bin tile of the general path, the
    range [first, end) of the mel columns whose packed runs
    (:func:`mel_columns`) meet its bins; (0, 0) where none does. Columns
    inside a range whose runs miss the tile (empty ones) add nothing."""
    nfft = cfg.padded_frame_length // 2
    starts, offsets, _ = mel_columns(analysis_matrices(cfg)[2])
    lens = np.diff(offsets)
    tiles = -(-nfft // _GEN_BINS)
    cols = np.zeros((tiles, 2), np.int32)
    for t in range(tiles):
        k0, k1 = t * _GEN_BINS, min((t + 1) * _GEN_BINS, nfft)
        hit = np.flatnonzero((lens > 0) & (starts < k1) & (starts + lens > k0))
        if hit.size:
            cols[t] = (hit[0], hit[-1] + 1)
    return cols


@lru_cache(maxsize=8)
def _device_tile_columns(cfg: FbankConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(general_tile_columns(cfg)).to(device)


def general_mel_terms(cfg: FbankConfig):
    """The general path's mel sums as the kernel takes them: (bin tile,
    column, first bin, end bin) for every column of a tile's range whose run
    meets the tile, the bins it adds there; a column's value is the sum of
    its terms in tile order (what the last tile to arrive adds)."""
    nfft = cfg.padded_frame_length // 2
    starts, offsets, _ = mel_columns(analysis_matrices(cfg)[2])
    terms = []
    for t, (lo_c, hi_c) in enumerate(general_tile_columns(cfg)):
        k0, k1 = t * _GEN_BINS, min((t + 1) * _GEN_BINS, nfft)
        for c in range(lo_c, hi_c):
            lo, hi = max(int(starts[c]), k0), min(int(starts[c]) + int(offsets[c + 1] - offsets[c]), k1)
            if lo < hi:
                terms.append((t, c, lo, hi))
    return terms


def general_plan(cfg: FbankConfig, batch: int, num_frames: int, dither: bool) -> dict:
    """K1's general-path launch plan (csrc/fbank.cu, fbank_general_kernel):
    a CTA of ``threads`` a tile of ``tile_frames`` frames x ``tile_bins``
    FFT bins of one utterance, ``frame_tiles * bin_tiles * batch`` CTAs;
    its K-loop stages ``chunk`` samples a step in a ring of ``stages``
    (A/B chunks, the frames' samples and, dithered, their draws): ``smem``
    bytes of shared memory; ``part_floats`` of scratch for the tiles' mel
    sums and ``tickets`` ints, one a (utterance, frame tile) (the C entry
    refuses smaller scratch)."""
    nfft = cfg.padded_frame_length // 2
    frame_tiles, bin_tiles = -(-num_frames // _GEN_FRAMES), -(-nfft // _GEN_BINS)
    stage = 2 * _GEN_K * _GEN_BINS + (2 if dither else 1) * _GEN_FRAMES * _GEN_XS
    return {"tile_frames": _GEN_FRAMES, "tile_bins": _GEN_BINS, "chunk": _GEN_K,
            "stages": _GEN_STAGES, "threads": _GEN_THREADS, "frame_tiles": frame_tiles,
            "bin_tiles": bin_tiles, "ctas": frame_tiles * bin_tiles * batch,
            "smem": 4 * _GEN_STAGES * stage,
            "part_floats": bin_tiles * batch * num_frames * cfg.num_bins,
            "tickets": batch * frame_tiles}

