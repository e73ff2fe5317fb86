"""Kaldi-compatible log-mel FBANK: numpy constants, a plain PyTorch version
and the CUDA kernel K1 (``csrc/fbank.cu``).

Numerically this is Kaldi ``compute-fbank-feats`` with the reference configs
(16 kHz, 25 ms window, 10 ms shift, preemphasis 0.97, remove-DC, Povey
window, 512-point FFT, snip-edges, mel 20 Hz to Nyquist, log floored at
FLT_EPSILON), dither off.

Every per-frame step before the power spectrum is linear in the frame, so it
folds into two constant matrices A, B of shape (frame_length, num_fft_bins):

    power[k] = (x @ A)[k]^2 + (x @ B)[k]^2
    fbank    = log(max(power @ M, FLT_EPSILON))

Waveforms are float32 in int16 scale (-32768..32767), as Kaldi reads PCM.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..kernels import FBANK, KernelError, check_cuda, ptr

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


def pcm16(w: np.ndarray) -> np.ndarray:
    """Quantize float samples to the int16 grid (round half to even, clip)."""
    return np.clip(np.rint(w), -32768, 32767)


def fbank_reference(waves: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """Plain PyTorch FBANK: (B, S) float32 -> (B, T, num_bins), T =
    num_frames(S). Frames by ``unfold`` and three float32 matmuls."""
    a, b, m = _device_matrices(cfg, waves.device)
    t = num_frames(waves.shape[1], cfg)
    if t == 0:
        return waves.new_zeros((waves.shape[0], 0, cfg.num_bins))
    frames = waves.float().unfold(1, cfg.frame_length, cfg.frame_shift)[:, :t]
    re = frames @ a
    im = frames @ b
    power = re * re + im * im
    if not cfg.use_power:
        power = torch.sqrt(power)
    mel = power @ m
    if cfg.use_log_fbank:
        mel = torch.log(torch.clamp(mel, min=FLT_EPSILON))
    return mel


def fbank(waves: torch.Tensor, cfg: FbankConfig = FbankConfig(dither=0.0)) -> torch.Tensor:
    """Batched log-mel FBANK, dither off: (B, S) or (S,) float32 int16-scale
    -> (B, T, num_bins) or (T, num_bins).

    On a CUDA tensor this launches K1 (``csrc/fbank.cu``); on a CPU tensor it
    runs :func:`fbank_reference`. Padded samples past an utterance's end give
    frames to be masked downstream.
    """
    if cfg.dither != 0.0:
        raise ValueError("fbank runs with dither off (cfg.dither=0); dither "
                         "is not on the serving path")
    if waves.ndim == 1:
        return fbank(waves[None], cfg)[0]
    if waves.device.type == "cpu":
        return fbank_reference(waves, cfg)

    check_cuda("fbank", waves, (torch.float32,), 2)
    batch, num_samples = waves.shape
    t = num_frames(num_samples, cfg)
    out = torch.empty((batch, t, cfg.num_bins), dtype=torch.float32,
                      device=waves.device)
    if t == 0 or batch == 0:
        return out
    if cfg.num_bins > 128:
        raise KernelError(f"fbank kernel takes at most 128 mel bins, got {cfg.num_bins}")
    a, b, m = _device_matrices(cfg, waves.device)
    FBANK.launch(
        "fbank_f32", waves.device, ptr(waves), ptr(a), ptr(b), ptr(m), ptr(out),
        batch, num_samples, t, cfg.frame_length, cfg.frame_shift, a.shape[1],
        cfg.num_bins, int(cfg.use_power), int(cfg.use_log_fbank), FLT_EPSILON)
    return out
