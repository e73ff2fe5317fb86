"""Data preparation, stage-gated like the reference prepare_data.sh; the JAX
package's ``cli/prepare_data.py`` in the port.

    python -m voxsrc2020_speaker_verification_tpu_torch.cli.prepare_data \
        --stage 2 --wav-root /corpora/voxceleb2/dev/wav \
        --dataset voxceleb2_dev --data-root data --feat-dim 80

Stages (mirroring /root/reference/prepare_data.sh:184-267):
  0  parallel wget of corpus archives from a URL manifest
     (ref download_vox.sh)
  1  md5 verification of downloaded archives against a 'md5 filename'
     manifest (the reference's md5sum_vox.txt works as input)
  2  create dataset dir from a wav tree (wav.scp/utt2spk/spk2utt/utt2dur)
  3  m4a -> 16 kHz mono wav via ffmpeg (VoxCeleb2; xargs-parallel equivalent)
  4  FBANK extraction on the card (K1, ``data/features.py``) + finalize
     (spk/utt2id/shards)
  5  MUSAN prep + 5x augmentation (reverb/noise/music/babble JSON specs)
     + FBANK extraction for the _aug dir (K1)

Stages 4-5 run on ``--device`` (default ``cuda``; ``cpu`` asks for the
plain path). The default manifests are this package's copies
(``data/manifests/``). A stage that fails exits non-zero.

Utterance/speaker naming follows the reference convention: utt = relative
wav path with '/' -> '-', speaker = first path component
(prepare_data.sh:50-55).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import glob
import hashlib
import os
import sys

from ..data import audio
from ..utils import datadir


def create_dataset(wav_root: str, data_dir: str, with_dur: bool = True) -> None:
    """wav tree -> data dir (ref prepare_data.sh:31-63 create_dataset)."""
    wav_root = os.path.abspath(wav_root)
    paths = sorted(
        glob.glob(os.path.join(wav_root, "**", "*.wav"), recursive=True)
    )
    wav, utt2spk = {}, {}
    for p in paths:
        rel = os.path.relpath(p, wav_root)
        utt = rel.replace(os.sep, "-")[: -len(".wav")]
        wav[utt] = p
        utt2spk[utt] = rel.split(os.sep)[0]
    os.makedirs(data_dir, exist_ok=True)
    datadir.write_two_column(os.path.join(data_dir, "wav.scp"), wav)
    datadir.write_two_column(os.path.join(data_dir, "utt2spk"), utt2spk)
    datadir.write_spk2utt(
        os.path.join(data_dir, "spk2utt"), datadir.utt2spk_to_spk2utt(utt2spk)
    )
    if with_dur:
        with cf.ThreadPoolExecutor(max_workers=16) as pool:
            durs = list(pool.map(audio.wav_duration, [wav[u] for u in sorted(wav)]))
        datadir.write_two_column(
            os.path.join(data_dir, "utt2dur"),
            {u: f"{d:.3f}" for u, d in zip(sorted(wav), durs)},
        )
    write_labels(data_dir)


def write_labels(data_dir: str) -> None:
    """spk list + utt2id.pkl (ref prepare_data.sh:76-81); needed up front by
    the raw-audio training mode, re-run harmlessly by finalize_dataset."""
    utt2spk = datadir.read_two_column(os.path.join(data_dir, "utt2spk"))
    spks = sorted(set(utt2spk.values()))
    with open(os.path.join(data_dir, "spk"), "w") as f:
        f.write("\n".join(spks) + "\n")
    datadir.save_utt2id(
        os.path.join(data_dir, "utt2id.pkl"),
        datadir.build_utt2id(utt2spk, spks),
    )


def convert_m4a(root: str, workers: int = 0) -> int:
    """Transcode every .m4a under root to .wav alongside it
    (ref prepare_data.sh:248-252). Needs ``ffmpeg`` on PATH when there is
    anything to convert."""
    files = glob.glob(os.path.join(root, "**", "*.m4a"), recursive=True)
    if files and not audio.have_ffmpeg():
        raise FileNotFoundError(f"{len(files)} m4a files under {root}, and no ffmpeg on PATH")
    workers = workers or (os.cpu_count() or 4)

    def one(src):
        dst = src[: -len(".m4a")] + ".wav"
        if not os.path.exists(dst):
            audio.ffmpeg_to_wav16k(src, dst)
        return dst

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(one, files))
    return len(files)


def download_archives(url_manifest: str, out_root: str, workers: int = 4) -> int:
    """Parallel wget of corpus archives (ref download_vox.sh:1-13).

    url_manifest: one URL per line ('#' comments allowed); credentials, if
    required by the host, belong in ~/.netrc.  Skips files already present.
    """
    import subprocess

    os.makedirs(out_root, exist_ok=True)
    with open(url_manifest) as f:
        urls = [l.strip() for l in f if l.strip() and not l.startswith("#")]

    # always run wget -c: it resumes truncated files and no-ops complete
    # ones -- pre-filtering on existence would strand partial downloads
    def fetch(url):
        subprocess.run(
            ["wget", "-q", "-c", "-P", out_root, url], check=True
        )

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(fetch, urls))
    return len(urls)


MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "manifests")
DEFAULT_URLS = os.path.join(MANIFEST_DIR, "vox_urls.txt")
DEFAULT_MD5 = os.path.join(MANIFEST_DIR, "vox_md5.txt")
DEFAULT_TRIALS = os.path.join(MANIFEST_DIR, "trials_urls.txt")

# Multi-part archives are concatenated back into the zips whose md5s the
# manifest also carries (ref prepare_data.sh:201-203).
ARCHIVE_PARTS = {
    "vox1_dev_wav.zip": [f"vox1_dev_wav_parta{c}" for c in "abcd"],
    "vox2_dev_aac.zip": [f"vox2_dev_aac_parta{c}" for c in "abcdefgh"],
}


def assemble_archives(archive_root: str) -> list:
    """cat part files into their combined zips (ref prepare_data.sh:201-202).
    Returns the archives assembled; skips ones already present or whose
    parts are incomplete."""
    made = []
    for zip_name, parts in ARCHIVE_PARTS.items():
        dst = os.path.join(archive_root, zip_name)
        srcs = [os.path.join(archive_root, p) for p in parts]
        if os.path.exists(dst) or not all(os.path.exists(s) for s in srcs):
            continue
        with open(dst + ".tmp", "wb") as out:
            for s in srcs:
                with open(s, "rb") as f:
                    while chunk := f.read(1 << 24):
                        out.write(chunk)
        os.rename(dst + ".tmp", dst)
        made.append(zip_name)
    return made


def download_trials(manifest: str, out_dir: str) -> int:
    """Fetch the cleaned VoxCeleb1 trial lists (ref prepare_data.sh:205-216).
    Manifest lines: '<url> <target filename>'."""
    import subprocess

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with open(manifest) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            url, name = line.split()
            subprocess.run(
                ["wget", "-q", "-O", os.path.join(out_dir, name), url],
                check=True)
            n += 1
    return n


def verify_md5(manifest: str, root: str) -> list:
    """Check downloaded archives against a 'md5 filename' manifest
    (ref prepare_data.sh:199, md5sum_vox.txt). Returns mismatched names."""
    bad = []
    with open(manifest) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            want, name = parts
            path = os.path.join(root, name)
            if not os.path.exists(path):
                bad.append(name + " (missing)")
                continue
            h = hashlib.md5()
            with open(path, "rb") as g:
                for chunk in iter(lambda: g.read(1 << 20), b""):
                    h.update(chunk)
            if h.hexdigest() != want:
                bad.append(name)
    return bad


def augment_stage(data_root: str, dataset: str, musan_root: str,
                  rirs_root: str, seed: int = 777) -> str:
    """MUSAN prep + 5x augmentation dir (ref prepare_data.sh:89-148)."""
    from ..data import augment, musan

    data_dir = os.path.join(data_root, dataset)
    musan_dirs = musan.make_musan_data_dirs(musan_root, data_root)

    def rir_list(room):
        pattern = os.path.join(
            rirs_root, "simulated_rirs", room, "**", "*.wav"
        )
        return sorted(glob.glob(pattern, recursive=True))

    # Prefer the corpus's rir_list metadata (room structure + probabilities,
    # the reference's exact sampling path, prepare_data.sh:119-121); fall
    # back to flat wav globs when the metadata files are absent.
    meta = [os.path.join(rirs_root, "simulated_rirs", room, "rir_list")
            for room in ("smallroom", "mediumroom")]
    reverb_policy = None
    if all(os.path.isfile(m) for m in meta):
        reverb_policy = augment.RoomReverbPolicy(
            [(0.5, m) for m in meta], seed=seed, base=rirs_root)

    out_dir = os.path.join(data_root, dataset + "_aug")
    augment.augment_data_dir(
        data_dir, out_dir,
        reverb_policy=reverb_policy,
        rir_sets=[(0.5, rir_list("smallroom")), (0.5, rir_list("mediumroom"))],
        musan_noise=musan.load_noise_durations(musan_dirs["noise"]),
        musan_music=musan.load_noise_durations(musan_dirs["music"]),
        musan_speech=musan.load_noise_durations(musan_dirs["speech"]),
        seed=seed,
    )
    write_labels(out_dir)
    return out_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stage", type=int, required=True, choices=[0, 1, 2, 3, 4, 5])
    p.add_argument("--url-manifest", default=DEFAULT_URLS,
                   help="stage 0: file of archive URLs to wget "
                        "(default: bundled VoxCeleb/RIRS/MUSAN manifest)")
    p.add_argument("--trials-manifest", default=DEFAULT_TRIALS,
                   help="stage 0: trial-list manifest "
                        "('<url> <name>' lines; bundled default)")
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset", default="voxceleb2_dev")
    p.add_argument("--wav-root", default=None)
    p.add_argument("--musan-root", default=None)
    p.add_argument("--rirs-root", default=None)
    p.add_argument("--archive-root", default=None)
    p.add_argument("--md5-manifest", default=DEFAULT_MD5)
    p.add_argument("--feat-dim", type=int, default=80)
    p.add_argument("--dither-seed", type=int, default=None)
    p.add_argument("--num-shards", type=int, nargs="+", default=[8, 16, 32])
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--device", default=None,
                   help="stages 4-5: FBANK's device (default cuda; 'cpu' runs the plain path)")
    return p


def require(ok, message: str) -> None:
    if not ok:
        sys.exit(f"cli.prepare_data: {message}")


def main(argv=None) -> str:
    """Returns what the stage made: the archive, data or output dir."""
    from .. import set_float32_precision
    set_float32_precision()
    args = build_parser().parse_args(argv)

    data_dir = os.path.join(args.data_root, args.dataset)
    if args.stage == 0:
        require(args.url_manifest and args.archive_root, "stage 0 needs --archive-root")
        n = download_archives(args.url_manifest, args.archive_root)
        print(f"downloaded {n} archives")
        t = download_trials(
            args.trials_manifest,
            os.path.join(args.data_root, "voxceleb1_trials"))
        print(f"downloaded {t} trial lists")
        return args.archive_root
    elif args.stage == 1:
        require(args.md5_manifest and args.archive_root, "stage 1 needs --archive-root")
        made = assemble_archives(args.archive_root)
        if made:
            print("assembled:", *made)
        bad = verify_md5(args.md5_manifest, args.archive_root)
        # part files may have been cleaned up post-assembly; only the
        # combined zips are required downstream
        bad = [b for b in bad
               if not (b.endswith("(missing)")
                       and any(b.split()[0] in parts
                               for parts in ARCHIVE_PARTS.values()))]
        if bad:
            print("MD5 FAILURES:", *bad, sep="\n  ")
            sys.exit(1)
        print("all archives verified")
        return args.archive_root
    elif args.stage == 2:
        require(args.wav_root, "stage 2 needs --wav-root")
        create_dataset(args.wav_root, data_dir)
        problems = datadir.validate_data_dir(data_dir)
        require(not problems, f"{data_dir}: {problems}")
        print(f"created {data_dir}")
        return data_dir
    elif args.stage == 3:
        require(args.wav_root, "stage 3 needs --wav-root")
        n = convert_m4a(args.wav_root)
        print(f"converted {n} m4a files")
        return args.wav_root
    elif args.stage == 4:
        from ..data.features import compute_features_for_dir, finalize_dataset
        scp = compute_features_for_dir(
            data_dir, args.feat_dim, dither_seed=args.dither_seed,
            progress_every=1000, device=args.device,
        )
        finalize_dataset(data_dir, args.feat_dim, num_shards=args.num_shards)
        print(f"features at {scp}")
        return data_dir
    elif args.stage == 5:
        require(args.musan_root and args.rirs_root, "stage 5 needs --musan-root and --rirs-root")
        from ..data.features import compute_features_for_dir, finalize_dataset
        out_dir = augment_stage(args.data_root, args.dataset,
                                args.musan_root, args.rirs_root, args.seed)
        scp = compute_features_for_dir(
            out_dir, args.feat_dim, dither_seed=args.dither_seed,
            progress_every=1000, device=args.device,
        )
        finalize_dataset(out_dir, args.feat_dim, num_shards=args.num_shards)
        print(f"augmented dataset at {out_dir}, features at {scp}")
        return out_dir


if __name__ == "__main__":
    main()
