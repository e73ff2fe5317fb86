"""Augmentation-spec rendering, the DSP core of the JAX package's
``data/augment.py`` (lines 47-143): Kaldi ``wav-reverberate`` semantics
without shell or Kaldi binaries.

* reverb: RIR convolution with ``--shift-output=true`` (output shifted left
  by the direct-path peak of the RIR) and the output power normalized back
  to the input power;
* additive noise: each noise scaled so 10*log10(P_signal/P_noise_scaled) =
  SNR, powers over the whole signal and the added segment (Kaldi AddNoise);
  ``extend`` loops a background noise to the signal's length
  (``wav-reverberate --duration=t``).

A wav.scp value is a wav path or a JSON spec (it starts with ``{``):

    {"source": wav_path, "rir": wav_path | null,
     "noises": [{"path": p, "snr": db, "start": samples, "extend": bool}, ...]}

``load_utterance`` renders either. ``data/native.py:render_spec`` is the C++
version of the same renderer. The RIR and MUSAN policies that write such
specs are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import audio


def _power(x: np.ndarray) -> float:
    return float(np.dot(x, x)) / max(len(x), 1)


def extend_to_duration(sig: np.ndarray, num_samples: int) -> np.ndarray:
    """Loop/truncate to an exact length (``wav-reverberate --duration=t``)."""
    if len(sig) >= num_samples:
        return sig[:num_samples]
    reps = int(math.ceil(num_samples / max(len(sig), 1)))
    return np.tile(sig, reps)[:num_samples]


def reverberate(sig: np.ndarray, rir: np.ndarray, shift_output: bool = True,
                normalize: bool = True) -> np.ndarray:
    """Convolve with an RIR, keeping the input length. ``shift_output`` drops
    the direct-path delay (argmax |rir|); ``normalize`` rescales the output
    to the input's power."""
    sig = np.asarray(sig, np.float64)
    rir = np.asarray(rir, np.float64)
    n = len(sig)
    full = np.fft.irfft(
        np.fft.rfft(sig, n=n + len(rir) - 1) * np.fft.rfft(rir, n=n + len(rir) - 1),
        n=n + len(rir) - 1,
    )
    shift = int(np.argmax(np.abs(rir))) if shift_output else 0
    out = full[shift: shift + n]
    if normalize:
        p_in, p_out = _power(sig), _power(out)
        if p_out > 0:
            out = out * math.sqrt(p_in / p_out)
    return out.astype(np.float32)


def add_noise(sig: np.ndarray, noise: np.ndarray, snr_db: float, start: int = 0) -> np.ndarray:
    """Mix ``noise`` into ``sig[start:start+len(noise)]`` at ``snr_db``:
    scale = sqrt(P_sig / (P_noise * 10^(snr/10))), P_sig over the whole
    signal, P_noise over the added segment."""
    out = np.asarray(sig, np.float32).copy()
    seg = noise[: max(0, len(sig) - start)]
    if len(seg) == 0:
        return out
    p_sig, p_noise = _power(out), _power(seg)
    if p_noise > 0:
        scale = math.sqrt(p_sig / (p_noise * (10.0 ** (snr_db / 10.0))))
        out[start: start + len(seg)] += (scale * seg).astype(np.float32)
    return out


def render_spec(spec: Dict, read_wav: Callable = audio.read_wav) -> Tuple[np.ndarray, int]:
    """Materialize an augmentation spec -> (samples, sample_rate)."""
    sig, sr = read_wav(spec["source"])
    if spec.get("rir"):
        rir, _ = read_wav(spec["rir"])
        sig = reverberate(sig, rir, shift_output=True)
    for nd in spec.get("noises", ()):
        noise, _ = read_wav(nd["path"])
        if nd.get("extend"):
            noise = extend_to_duration(noise, len(sig))
        sig = add_noise(sig, noise, nd["snr"], int(nd.get("start", 0)))
    return sig, sr


def parse_spec(value: str) -> Optional[Dict]:
    """wav.scp value -> spec dict (JSON specs start with '{'), else None."""
    value = value.strip()
    if value.startswith("{"):
        return json.loads(value)
    return None


def load_utterance(wav_scp_value: str) -> Tuple[np.ndarray, int]:
    """Load either a plain wav path or a JSON augmentation spec."""
    spec = parse_spec(wav_scp_value)
    if spec is not None:
        return render_spec(spec)
    return audio.read_wav(wav_scp_value)
