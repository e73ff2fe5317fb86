"""Kaldi data-directory conventions: wav.scp / utt2spk / spk2utt / spk /
utt2id, plus split/combine/validate utilities.

The port's copy of the JAX package's ``utils/datadir.py`` (the port imports
nothing of that package). Typed Python in place of the reference's perl and
shell data-dir tools (utils/*.sh, utils/split_scp.pl, utt2id.py); file
formats stay byte-compatible, so data dirs prepared by either package
interoperate.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Dict, List, Optional, Sequence, Tuple


def read_two_column(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if parts:
                out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def write_two_column(path: str, mapping: Dict[str, str], sort: bool = True) -> None:
    keys = sorted(mapping) if sort else list(mapping)
    with open(path, "w") as f:
        for k in keys:
            f.write(f"{k} {mapping[k]}\n")


def utt2spk_to_spk2utt(utt2spk: Dict[str, str]) -> Dict[str, List[str]]:
    spk2utt: Dict[str, List[str]] = {}
    for utt, spk in utt2spk.items():
        spk2utt.setdefault(spk, []).append(utt)
    for utts in spk2utt.values():
        utts.sort()
    return spk2utt


def spk2utt_to_utt2spk(spk2utt: Dict[str, List[str]]) -> Dict[str, str]:
    return {utt: spk for spk, utts in spk2utt.items() for utt in utts}


def read_spk2utt(path: str) -> Dict[str, List[str]]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def write_spk2utt(path: str, spk2utt: Dict[str, List[str]]) -> None:
    with open(path, "w") as f:
        for spk in sorted(spk2utt):
            f.write(f"{spk} {' '.join(spk2utt[spk])}\n")


def build_utt2id(utt2spk: Dict[str, str], spk_list: Sequence[str]) -> Dict[str, int]:
    """utt -> int32 speaker label (ref utt2id.py:20-53: id = index into the
    sorted speaker list)."""
    spk2id = {spk: i for i, spk in enumerate(spk_list)}
    return {utt: spk2id[spk] for utt, spk in utt2spk.items()}


def save_utt2id(path: str, utt2id: Dict[str, int]) -> None:
    with open(path, "wb") as f:
        pickle.dump(utt2id, f)


def load_utt2id(path: str) -> Dict[str, int]:
    with open(path, "rb") as f:
        return pickle.load(f)


def split_scp_lines(lines: Sequence[str], num_splits: int) -> List[List[str]]:
    """Deterministic near-equal split, preserving order within each shard
    (ref utils/split_scp.pl default mode)."""
    n = len(lines)
    out = []
    start = 0
    for i in range(num_splits):
        size = n // num_splits + (1 if i < n % num_splits else 0)
        out.append(list(lines[start: start + size]))
        start += size
    return out


def split_scp_lines_by_speaker(
    lines: Sequence[str], num_splits: int, utt2spk: Dict[str, str]
) -> List[List[str]]:
    """Speaker-coherent split (ref utils/split_scp.pl --utt2spk mode): every
    speaker's utterances land in ONE shard.  Mirrors the reference algorithm:
    group lines per speaker in order of first appearance, seed shard
    ``spk_idx * num_splits // num_spks``, then greedily move boundary
    speakers between adjacent shards while that shrinks the absolute
    utterance-count difference (the perl's provably-converging balance loop).
    Raises if there are fewer speakers than shards (the perl dies too).
    """
    spk_order: List[str] = []
    spk_lines: Dict[str, List[str]] = {}
    for line in lines:
        utt = line.split()[0]
        spk = utt2spk.get(utt)
        if spk is None:
            raise KeyError(f"utterance {utt!r} missing from utt2spk")
        if spk not in spk_lines:
            spk_order.append(spk)
            spk_lines[spk] = []
        spk_lines[spk].append(line)
    numspks = len(spk_order)
    if numspks < num_splits:
        raise ValueError(
            f"refusing to split: {numspks} speakers < {num_splits} shards "
            "(ref split_scp.pl would emit empty scps and exit nonzero)")
    shard_spks: List[List[str]] = [[] for _ in range(num_splits)]
    shard_count = [0] * num_splits
    for spkidx, spk in enumerate(spk_order):
        scpidx = spkidx * num_splits // numspks
        shard_spks[scpidx].append(spk)
        shard_count[scpidx] += len(spk_lines[spk])
    changed = True
    while changed:
        changed = False
        for i in range(num_splits):
            if i < num_splits - 1 and shard_spks[i]:
                spk = shard_spks[i][-1]
                c = len(spk_lines[spk])
                n1, n2 = shard_count[i], shard_count[i + 1]
                if abs((n2 + c) - (n1 - c)) < abs(n2 - n1):
                    shard_count[i + 1] += c
                    shard_count[i] -= c
                    shard_spks[i].pop()
                    shard_spks[i + 1].insert(0, spk)
                    changed = True
            if i > 0 and shard_spks[i]:
                spk = shard_spks[i][0]
                c = len(spk_lines[spk])
                n1, n2 = shard_count[i - 1], shard_count[i]
                if abs((n2 - c) - (n1 + c)) < abs(n2 - n1):
                    shard_count[i - 1] += c
                    shard_count[i] -= c
                    shard_spks[i].pop(0)
                    shard_spks[i - 1].append(spk)
                    changed = True
    return [[ln for spk in spks for ln in spk_lines[spk]]
            for spks in shard_spks]


def shard_scp(scp_path: str, num_splits: int, out_dir: Optional[str] = None,
              utt2spk: Optional[Dict[str, str]] = None) -> List[str]:
    """Shard an scp into `{N}-split/feats.{i}.scp` files (ref
    prepare_data.sh:31-43 shard_scp).  With ``utt2spk``, shards are
    speaker-coherent (ref split_scp.pl --utt2spk mode)."""
    base_dir = out_dir or os.path.dirname(os.path.abspath(scp_path))
    split_dir = os.path.join(base_dir, f"{num_splits}-split")
    os.makedirs(split_dir, exist_ok=True)
    with open(scp_path) as f:
        lines = [l for l in f.read().splitlines() if l.strip()]
    chunks = (split_scp_lines_by_speaker(lines, num_splits, utt2spk)
              if utt2spk is not None
              else split_scp_lines(lines, num_splits))
    paths = []
    for i, chunk in enumerate(chunks):
        p = os.path.join(split_dir, f"feats.{i + 1}.scp")
        with open(p, "w") as f:
            f.write("\n".join(chunk) + ("\n" if chunk else ""))
        paths.append(p)
    return paths


def shuffle_scp(scp_path: str, seed: int = 777) -> None:
    """In-place deterministic shuffle (ref prepare_data.sh:57 `shuf`)."""
    with open(scp_path) as f:
        lines = [l for l in f.read().splitlines() if l.strip()]
    random.Random(seed).shuffle(lines)
    with open(scp_path, "w") as f:
        f.write("\n".join(lines) + "\n")


def combine_data_dirs(out_dir: str, in_dirs: Sequence[str],
                      files: Sequence[str] = ("wav.scp", "utt2spk")) -> None:
    """Concatenate data dirs (ref utils/combine_data.sh)."""
    os.makedirs(out_dir, exist_ok=True)
    for name in files:
        merged: Dict[str, str] = {}
        for d in in_dirs:
            p = os.path.join(d, name)
            if os.path.exists(p):
                merged.update(read_two_column(p))
        write_two_column(os.path.join(out_dir, name), merged)
    u2s_path = os.path.join(out_dir, "utt2spk")
    if os.path.exists(u2s_path):
        write_spk2utt(os.path.join(out_dir, "spk2utt"),
                      utt2spk_to_spk2utt(read_two_column(u2s_path)))


def validate_data_dir(path: str) -> List[str]:
    """Invariant checks (ref utils/validate_data_dir.sh): sorted unique keys,
    utt2spk/spk2utt consistency, wav.scp coverage.  Returns problem strings."""
    problems = []
    utt2spk_p = os.path.join(path, "utt2spk")
    wav_p = os.path.join(path, "wav.scp")
    if not os.path.exists(utt2spk_p):
        return [f"missing {utt2spk_p}"]
    utt2spk = read_two_column(utt2spk_p)
    with open(utt2spk_p) as f:
        keys = [l.split()[0] for l in f if l.strip()]
    if keys != sorted(keys):
        problems.append("utt2spk not sorted")
    if len(keys) != len(set(keys)):
        problems.append("duplicate utts in utt2spk")
    if os.path.exists(wav_p):
        wavs = read_two_column(wav_p)
        missing = set(utt2spk) - set(wavs)
        if missing:
            problems.append(f"{len(missing)} utts missing from wav.scp")
    s2u_p = os.path.join(path, "spk2utt")
    if os.path.exists(s2u_p):
        s2u = read_spk2utt(s2u_p)
        if spk2utt_to_utt2spk(s2u) != utt2spk:
            problems.append("spk2utt inconsistent with utt2spk")
    return problems


def copy_data_dir(src: str, dst: str, utt_suffix: str = "",
                  files: Sequence[str] = ("wav.scp", "utt2spk", "utt2dur")) -> None:
    """Copy a data dir, optionally suffixing utt ids
    (ref utils/copy_data_dir.sh --utt-suffix, used for the -reverb copy)."""
    os.makedirs(dst, exist_ok=True)
    for name in files:
        p = os.path.join(src, name)
        if not os.path.exists(p):
            continue
        mapping = read_two_column(p)
        write_two_column(
            os.path.join(dst, name),
            {u + utt_suffix: v for u, v in mapping.items()},
        )
    u2s = os.path.join(dst, "utt2spk")
    if os.path.exists(u2s):
        write_spk2utt(os.path.join(dst, "spk2utt"),
                      utt2spk_to_spk2utt(read_two_column(u2s)))


def subset_data_dir(src: str, dst: str, utts: Sequence[str],
                    files: Sequence[str] = ("wav.scp", "utt2spk", "utt2dur")) -> None:
    """Keep only `utts` (ref utils/subset_data_dir.sh)."""
    keep = set(utts)
    os.makedirs(dst, exist_ok=True)
    for name in files:
        p = os.path.join(src, name)
        if not os.path.exists(p):
            continue
        mapping = read_two_column(p)
        write_two_column(os.path.join(dst, name),
                         {u: v for u, v in mapping.items() if u in keep})
    u2s = os.path.join(dst, "utt2spk")
    if os.path.exists(u2s):
        write_spk2utt(os.path.join(dst, "spk2utt"),
                      utt2spk_to_spk2utt(read_two_column(u2s)))


def fix_data_dir(path: str) -> None:
    """Sort + reconcile utt2spk/spk2utt/wav.scp to their intersection
    (ref utils/fix_data_dir.sh)."""
    utt2spk = read_two_column(os.path.join(path, "utt2spk"))
    wav_p = os.path.join(path, "wav.scp")
    if os.path.exists(wav_p):
        wavs = read_two_column(wav_p)
        keep = sorted(set(utt2spk) & set(wavs))
        utt2spk = {u: utt2spk[u] for u in keep}
        write_two_column(wav_p, {u: wavs[u] for u in keep})
    write_two_column(os.path.join(path, "utt2spk"), utt2spk)
    write_spk2utt(os.path.join(path, "spk2utt"), utt2spk_to_spk2utt(utt2spk))
