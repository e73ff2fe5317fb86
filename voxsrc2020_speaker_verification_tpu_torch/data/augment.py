"""Augmentation DSP and policies, the JAX package's ``data/augment.py``:
Kaldi ``wav-reverberate`` semantics without shell or Kaldi binaries.

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
version of the same renderer.

The policies write such specs (the reference's recipes, prepare_data.sh:
119-148): reverb over RIRs drawn from the smallroom/mediumroom lists at
p = 0.5/0.5 (flat lists, or ``rir_list`` metadata with its rooms and
smoothed probabilities: reverberate_data_dir.py:240-301, 458-551); MUSAN
noise (foreground, SNRs {15,10,5,0} dB, 1 s apart), music (one background
noise, SNRs {15,10,8,5}) and babble (3-7 background speech utterances, SNRs
{20,17,15,13}); ``augment_data_dir`` writes the 5x dir (original + reverb +
noise + music + babble, utterance suffixes -reverb/-noise/-music/-babble,
same speakers). Every draw comes from ``random.Random(seed)``, in the
reference's order, so a corpus and seed give the same specs byte for byte
in either package.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# RIR-list metadata (the reference's general machinery,
# steps/data/reverberate_data_dir.py:458-551)
# ---------------------------------------------------------------------------

def smooth_probabilities(
    probs: Sequence[Optional[float]],
    smoothing_weight: float = 0.0,
    target_sum: float = 1.0,
) -> List[float]:
    """Reference smooth_probability_distribution (reverberate_data_dir.py:
    458-490): unspecified entries share the probability mass left by the
    specified ones uniformly; specified ones are blended toward uniform by
    `smoothing_weight`; the result is normalized to `target_sum`."""
    probs = list(probs)
    if not probs:
        return []
    unspecified = [i for i, p in enumerate(probs) if p is None]
    acc = sum(p for p in probs if p is not None)
    uniform = ((1.0 - acc) / len(unspecified)
               if unspecified and acc < 1.0 else 0.0)
    out = [
        uniform if p is None
        else (1.0 - smoothing_weight) * p + smoothing_weight * uniform
        for p in probs
    ]
    total = sum(out)
    return [p / total * target_sum for p in out]


def _rebase_location(loc: str, base: Optional[str]) -> str:
    """RIRS_NOISES rir_list locations are corpus-relative (e.g.
    'RIRS_NOISES/simulated_rirs/smallroom/Room001/....wav', ref
    reverberate_data_dir.py runs from the corpus parent).  Rebase them
    against the corpus root so specs carry usable paths from any cwd."""
    if base is None or os.path.isabs(loc):
        return loc
    first, _, rest = loc.partition("/")
    if rest and first == os.path.basename(os.path.normpath(base)):
        cand = os.path.join(base, rest)  # 'RIRS_NOISES/x' under base
        if os.path.exists(cand):
            return cand
    cand = os.path.join(base, loc)
    return cand if os.path.exists(cand) else loc


def parse_rir_list(
    path: str, smoothing_weight: float = 0.3, base: Optional[str] = None
) -> List[Dict]:
    """Parse a RIRS_NOISES ``rir_list`` metadata file
    (reverberate_data_dir.py:516-551): lines of
    ``--rir-id X --room-id Y [--probability p] <location>`` ->
    [{rir_id, room_id, probability, path}], probabilities smoothed with the
    reference's default rir_smoothing_weight 0.3.  ``base`` rebases
    corpus-relative RIR locations (pass the RIRS_NOISES root)."""
    records: List[Dict] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            rec: Dict = {"rir_id": None, "room_id": None,
                         "probability": None,
                         "path": _rebase_location(toks[-1], base)}
            i = 0
            while i < len(toks) - 1:
                key = toks[i]
                if key == "--rir-id":
                    rec["rir_id"] = toks[i + 1]
                elif key == "--room-id":
                    rec["room_id"] = toks[i + 1]
                elif key == "--probability":
                    rec["probability"] = float(toks[i + 1])
                i += 2 if key.startswith("--") else 1
            records.append(rec)
    for rec, p in zip(records, smooth_probabilities(
            [r["probability"] for r in records], smoothing_weight)):
        rec["probability"] = p
    return records


def make_room_dict(rirs: Sequence[Dict]) -> Dict[str, Dict]:
    """Group RIRs by room (reverberate_data_dir.py make_room_dict): room
    probability = sum of its RIRs' probabilities."""
    rooms: Dict[str, Dict] = {}
    for rir in rirs:
        room = rooms.setdefault(
            rir["room_id"], {"probability": 0.0, "rir_list": []})
        room["probability"] += rir["probability"]
        room["rir_list"].append(rir)
    return rooms


def _pick_with_probability(rng: random.Random, items, probs):
    """pick_item_with_probability (reverberate_data_dir.py:132-152)."""
    r = rng.random()
    acc = 0.0
    for item, p in zip(items, probs):
        acc += p
        if r <= acc:
            return item
    return items[-1]


# ---------------------------------------------------------------------------
# Policies (sampling distributions of the reference recipes)
# ---------------------------------------------------------------------------

class ReverbPolicy:
    """speech_rvb_probability=1 over smallroom+mediumroom at p=0.5/0.5
    (prepare_data.sh:119-132). `rir_sets` = [(prob, [rir wav paths]), ...];
    a set is picked by probability, then an RIR uniformly within it (the
    reference weights RIRs uniformly inside a room list)."""

    def __init__(self, rir_sets: Sequence[Tuple[float, Sequence[str]]],
                 rvb_probability: float = 1.0, seed: int = 777):
        total = sum(p for p, _ in rir_sets)
        self.rir_sets = [(p / total, list(rirs)) for p, rirs in rir_sets]
        self.rvb_probability = rvb_probability
        self.rng = random.Random(seed)

    def sample(self, source: str) -> Dict:
        spec = {"source": source, "rir": None, "noises": []}
        if self.rng.random() < self.rvb_probability:
            r = self.rng.random()
            acc = 0.0
            for p, rirs in self.rir_sets:
                acc += p
                if r <= acc or (p, rirs) == self.rir_sets[-1]:
                    spec["rir"] = self.rng.choice(rirs)
                    break
        return spec


class RoomReverbPolicy:
    """Room-aware RIR sampling from RIRS_NOISES ``rir_list`` metadata --
    the reference's general path (reverberate_data_dir.py:240-301): RIR-set
    probabilities are distributed over each set's (smoothed) RIR
    probabilities, RIRs are grouped by room, and sampling picks a room by
    probability then an RIR within it.  For the recipe's uniform simulated
    lists this reduces to ReverbPolicy's per-set uniform choice, but
    user-supplied probabilities and real-RIR room structure are honored.

    ``set_params``: [(probability | None, rir_list path)], e.g. the
    recipe's [(0.5, .../smallroom/rir_list), (0.5, .../mediumroom/rir_list)]
    (ref prepare_data.sh:119-121)."""

    def __init__(
        self,
        set_params: Sequence[Tuple[Optional[float], str]],
        rvb_probability: float = 1.0,
        smoothing_weight: float = 0.3,
        seed: int = 777,
        base: Optional[str] = None,
    ):
        set_probs = smooth_probabilities([p for p, _ in set_params])
        rirs: List[Dict] = []
        for (_, path), sp in zip(set_params, set_probs):
            sub = parse_rir_list(path, smoothing_weight, base=base)
            for r in sub:
                r["probability"] *= sp  # parse_rir_list normalized to 1
            rirs.extend(sub)
        self.rooms = make_room_dict(rirs)
        self._room_ids = sorted(self.rooms)
        self._room_probs = [self.rooms[r]["probability"]
                            for r in self._room_ids]
        self.rvb_probability = rvb_probability
        self.rng = random.Random(seed)

    def sample(self, source: str) -> Dict:
        spec = {"source": source, "rir": None, "noises": []}
        if self.rng.random() < self.rvb_probability:
            room_id = _pick_with_probability(
                self.rng, self._room_ids, self._room_probs)
            room = self.rooms[room_id]
            rir = _pick_with_probability(
                self.rng, room["rir_list"],
                [r["probability"] / room["probability"]
                 for r in room["rir_list"]])
            spec["rir"] = rir["path"]
        return spec


class AdditiveNoisePolicy:
    """Foreground/background additive-noise policy
    (steps/data/augment_data_dir.py:104-151).

    foreground: noises tiled sequentially from t=0, `interval` seconds apart,
    until the utterance duration is covered.
    background: `num_choices`-sampled count of noises, each looping over the
    full duration from t=0.
    """

    def __init__(
        self,
        noises: Dict[str, float],          # path -> duration (s)
        snrs: Sequence[float],
        foreground: bool = True,
        interval: float = 1.0,
        num_choices: Sequence[int] = (1,),
        sample_rate: int = 16000,
        seed: int = 777,
    ):
        self.paths = sorted(noises)
        self.durations = noises
        self.snrs = list(snrs)
        self.foreground = foreground
        self.interval = interval
        self.num_choices = list(num_choices)
        self.sample_rate = sample_rate
        self.rng = random.Random(seed)

    def sample(self, source: str, duration: float) -> Dict:
        noises: List[Dict] = []
        if self.foreground:
            t = 0.0
            while t < duration:
                path = self.rng.choice(self.paths)
                noises.append({
                    "path": path,
                    "snr": self.rng.choice(self.snrs),
                    "start": int(round(t * self.sample_rate)),
                    "extend": False,
                })
                t += self.durations[path] + self.interval
        else:
            for _ in range(self.rng.choice(self.num_choices)):
                noises.append({
                    "path": self.rng.choice(self.paths),
                    "snr": self.rng.choice(self.snrs),
                    "start": 0,
                    "extend": True,
                })
        return {"source": source, "rir": None, "noises": noises}


def musan_noise_policy(noises: Dict[str, float], seed: int = 777):
    """MUSAN noise: fg SNRs 15:10:5:0, interval 1 s (prepare_data.sh:140)."""
    return AdditiveNoisePolicy(noises, [15, 10, 5, 0], foreground=True,
                               interval=1.0, seed=seed)


def musan_music_policy(noises: Dict[str, float], seed: int = 777):
    """MUSAN music: 1 bg noise, SNRs 15:10:8:5 (prepare_data.sh:142)."""
    return AdditiveNoisePolicy(noises, [15, 10, 8, 5], foreground=False,
                               num_choices=[1], seed=seed)


def musan_babble_policy(noises: Dict[str, float], seed: int = 777):
    """MUSAN babble: 3-7 bg speech utts, SNRs 20:17:15:13 (prepare_data.sh:144)."""
    return AdditiveNoisePolicy(noises, [20, 17, 15, 13], foreground=False,
                               num_choices=[3, 4, 5, 6, 7], seed=seed)


# ---------------------------------------------------------------------------
# Data-dir level orchestration (prepare_data.sh:89-181)
# ---------------------------------------------------------------------------

AUG_SUFFIXES = ("reverb", "noise", "music", "babble")


def augment_data_dir(
    data_dir: str,
    out_dir: str,
    rir_sets: Sequence[Tuple[float, Sequence[str]]],
    musan_noise: Dict[str, float],
    musan_music: Dict[str, float],
    musan_speech: Dict[str, float],
    utt2dur: Optional[Dict[str, float]] = None,
    seed: int = 777,
    reverb_policy=None,
) -> None:
    """Write the 5x `<dataset>_aug` dir: original + the four augmented copies,
    wav.scp values = JSON specs, labels preserved via utt suffixes.
    ``reverb_policy`` (e.g. a RoomReverbPolicy built from rir_list metadata)
    overrides the flat-list ReverbPolicy built from ``rir_sets``."""
    from ..utils import datadir

    wav = datadir.read_two_column(os.path.join(data_dir, "wav.scp"))
    utt2spk = datadir.read_two_column(os.path.join(data_dir, "utt2spk"))
    if utt2dur is None:
        utt2dur = {
            k: float(v) for k, v in datadir.read_two_column(
                os.path.join(data_dir, "utt2dur")
            ).items()
        }

    policies = {
        "reverb": reverb_policy or ReverbPolicy(rir_sets, seed=seed),
        "noise": musan_noise_policy(musan_noise, seed=seed + 1),
        "music": musan_music_policy(musan_music, seed=seed + 2),
        "babble": musan_babble_policy(musan_speech, seed=seed + 3),
    }

    new_wav: Dict[str, str] = dict(wav)
    new_utt2spk: Dict[str, str] = dict(utt2spk)
    for utt in sorted(wav):
        for suffix in AUG_SUFFIXES:
            pol = policies[suffix]
            if suffix == "reverb":
                spec = pol.sample(wav[utt])
            else:
                spec = pol.sample(wav[utt], utt2dur[utt])
            aug_utt = f"{utt}-{suffix}"
            new_wav[aug_utt] = json.dumps(spec, separators=(",", ":"))
            new_utt2spk[aug_utt] = utt2spk[utt]

    os.makedirs(out_dir, exist_ok=True)
    datadir.write_two_column(os.path.join(out_dir, "wav.scp"), new_wav)
    datadir.write_two_column(os.path.join(out_dir, "utt2spk"), new_utt2spk)
    datadir.write_spk2utt(
        os.path.join(out_dir, "spk2utt"),
        datadir.utt2spk_to_spk2utt(new_utt2spk),
    )
