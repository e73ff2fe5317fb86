"""MUSAN corpus preparation, the JAX package's ``data/musan.py`` in the port.

Walks the MUSAN tree into music/speech/noise data dirs, filtering music
tracks with vocals via the ANNOTATIONS files -- the semantics of the
reference's steps/data/make_musan.py:30-156 and make_musan.sh:45-66 (16 kHz
assumed; resampling, if ever needed, happens in data prep via ffmpeg).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

from ..utils import datadir


def process_music_annotations(path: str) -> Tuple[Dict[str, str], Dict[str, bool]]:
    """ANNOTATIONS line: 'utt genre vocals(Y/N)' -> (utt2spk, utt2vocals)
    (ref make_musan.py:30-51; spk = utt for music)."""
    utt2spk, utt2vocals = {}, {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 3:
                utt, _, vocals = parts[0], parts[1], parts[2]
                utt2spk[utt] = utt
                utt2vocals[utt] = vocals == "Y"
    return utt2spk, utt2vocals


def _walk_wavs(root: str) -> Dict[str, str]:
    utt2wav = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".wav"):
                utt2wav[name[: -len(".wav")]] = os.path.join(dirpath, name)
    return utt2wav


def prepare_music(musan_root: str, use_vocals: bool = False) -> Dict[str, str]:
    """music utts (vocals filtered out unless use_vocals), utt -> wav path."""
    music_dir = os.path.join(musan_root, "music")
    utt2wav = _walk_wavs(music_dir)
    utt2vocals: Dict[str, bool] = {}
    for dirpath, _, files in os.walk(music_dir):
        if "ANNOTATIONS" in files:
            _, vocals = process_music_annotations(os.path.join(dirpath, "ANNOTATIONS"))
            utt2vocals.update(vocals)
    return {
        utt: utt2wav[utt]
        for utt in utt2vocals
        if utt in utt2wav and (use_vocals or not utt2vocals[utt])
    }


def prepare_flat(musan_root: str, subset: str) -> Dict[str, str]:
    """speech/noise: every wav, spk = utt (ref make_musan.py:92-156)."""
    return _walk_wavs(os.path.join(musan_root, subset))


def make_musan_data_dirs(musan_root: str, out_root: str,
                         use_vocals: bool = False) -> Dict[str, str]:
    """Write data/musan_{music,speech,noise} dirs with wav.scp/utt2spk/
    reco2dur (durations from wav headers, replacing get_utt2dur.sh).
    Returns {subset: data_dir_path}."""
    from . import audio

    subsets = {
        "music": prepare_music(musan_root, use_vocals),
        "speech": prepare_flat(musan_root, "speech"),
        "noise": prepare_flat(musan_root, "noise"),
    }
    out = {}
    for name, utt2wav in subsets.items():
        d = os.path.join(out_root, f"musan_{name}")
        os.makedirs(d, exist_ok=True)
        datadir.write_two_column(os.path.join(d, "wav.scp"), utt2wav)
        datadir.write_two_column(
            os.path.join(d, "utt2spk"), {u: u for u in utt2wav}
        )
        datadir.write_spk2utt(
            os.path.join(d, "spk2utt"), {u: [u] for u in sorted(utt2wav)}
        )
        reco2dur = {
            u: f"{audio.wav_duration(p):.2f}" for u, p in utt2wav.items()
        }
        datadir.write_two_column(os.path.join(d, "reco2dur"), reco2dur)
        out[name] = d
    return out


def load_noise_durations(data_dir: str) -> Dict[str, float]:
    """{wav_path: duration} for an augmentation policy, joining wav.scp with
    reco2dur (the policies key noises by path, not utt)."""
    wav = datadir.read_two_column(os.path.join(data_dir, "wav.scp"))
    dur = datadir.read_two_column(os.path.join(data_dir, "reco2dur"))
    return {wav[u]: float(dur[u]) for u in wav if u in dur}
