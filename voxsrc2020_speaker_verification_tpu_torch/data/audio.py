"""Waveform IO, the JAX package's ``data/audio.py``.

Reads PCM WAV into float32 arrays in *int16 scale* (-32768..32767), the
convention Kaldi (and therefore ``ops/fbank.py``) expects. VoxCeleb2 m4a
transcoding goes through ffmpeg as the reference does
(prepare_data.sh:248-252), where the binary is present.

``read_wav`` here is Python's ``wave`` module only; the native C++ reader of
16-bit files is ``data/native.py:read_wav``, and its callers choose it
explicitly (the JAX package's reader prefers it silently when built).
"""

from __future__ import annotations

import io
import subprocess
import wave
from typing import Tuple

import numpy as np


def read_wav(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Read an 8-, 16- or 32-bit PCM wav file (a path or its bytes) ->
    (float32 samples in int16 scale, sample_rate). Multi-channel audio is
    averaged to mono."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        fd = io.BytesIO(path_or_bytes)
    else:
        fd = open(path_or_bytes, "rb")
    try:
        with wave.open(fd, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            channels = w.getnchannels()
            raw = w.readframes(n)
        if width == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        elif width == 1:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
        elif width == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        if channels > 1:
            data = data.reshape(-1, channels).mean(axis=1)
        return data, sr
    finally:
        fd.close()


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write float32 int16-scale samples as 16-bit PCM mono wav."""
    pcm = np.clip(np.round(samples), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def ffmpeg_to_wav16k(src: str, dst: str) -> None:
    """m4a/any -> 16 kHz mono PCM wav via ffmpeg (ref prepare_data.sh:250-251)."""
    subprocess.run(
        ["ffmpeg", "-y", "-v", "quiet", "-i", src,
         "-ar", "16000", "-ac", "1", "-f", "wav", dst],
        check=True,
    )


def have_ffmpeg() -> bool:
    from shutil import which
    return which("ffmpeg") is not None


def wav_duration(path: str) -> float:
    """Duration in seconds from the wav header (Kaldi's utt2dur)."""
    with wave.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()
