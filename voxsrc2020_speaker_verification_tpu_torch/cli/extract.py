"""Embedding extraction CLI, the JAX package's ``cli/extract.py`` on the GPU.

The reference's per-GPU tf_extract.py orchestration
(eval_inference_model.sh:27-40, tf_extract.py:45-113):

    python -m voxsrc2020_speaker_verification_tpu_torch.cli.extract \\
        --artifact exp/.../artifact --data-dir data/voxceleb1 \\
        --out data/voxceleb1/xvector

One card runs large bucket batches with masked pooling
(``eval/extract.py``); ``--num-devices N`` splits each batch's rows over N
cards, a replica of the model on each, from this one process. Sliding
CMVN normalizes each FULL utterance before chunking, as the reference's
apply-cmvn-sliding feeder pipe does
(tf_extract.py:63): on the card by default (``--cmvn device``: K7 in
length-bucketed batches) or on the host when asked (``--cmvn host``: a
float64 cumulative sum per utterance, the JAX package's default). ``--raw``
reads wav.scp (wav paths or JSON augmentation specs) and computes FBANK
with K1 on the card (``data/features.py:wave_feature_batches``) instead of
reading a feature scp; with device CMVN the features stay on the card from
K1 to the forward. Everything runs on ``cuda`` unless ``--device cpu`` asks
for the plain path.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

CMVN_BUCKETS = (500, 1000, 2000, 4000, 8000, 16000)
WAVE_BUCKETS_S = (4, 8, 16, 32, 64, 128)


def cmvn_full_stream(stream, window: int = 300, batch_size: int = 8,
                     bucket_frames=CMVN_BUCKETS,
                     device: Optional[Union[str, torch.device]] = None):
    """(utt, raw (T, F) feats) -> (utt, CMVN'd (T, F) float32 tensor on
    ``device``), each FULL utterance normalized by K7
    (``ops/cmvn.py:sliding_cmvn``, centred) on ``device`` (default
    ``cuda``) in length-bucketed batches of ``batch_size`` rows; a tail
    batch is padded with one-frame rows. An utterance beyond the largest
    bucket runs alone at its exact length. The input rows are numpy arrays
    (packed on the host, one copy a batch) or tensors already on
    ``device`` (packed there)."""
    from .. import resolve_device
    from ..ops.cmvn import sliding_cmvn

    dev = resolve_device(device)
    pending = {b: [] for b in bucket_frames}

    def flush(bucket, batch):
        if not batch:
            return
        rows = batch_size if bucket in pending else len(batch)
        shape = (rows, bucket, batch[0][1].shape[1])
        if isinstance(batch[0][1], torch.Tensor):
            f = torch.zeros(shape, device=dev)
        else:
            f = np.zeros(shape, np.float32)
        n = np.ones(rows, np.int32)
        for i, (_, feat) in enumerate(batch):
            f[i, : len(feat)] = feat
            n[i] = len(feat)
        out = sliding_cmvn(torch.as_tensor(f).to(dev), torch.from_numpy(n).to(dev),
                           window=window, center=True)
        for i, (utt, feat) in enumerate(batch):
            yield utt, out[i, : len(feat)]

    for utt, feat in stream:
        bucket = next((b for b in bucket_frames if len(feat) <= b), None)
        if bucket is None:
            yield from flush(len(feat), [(utt, feat)])
            continue
        pending[bucket].append((utt, feat))
        if len(pending[bucket]) >= batch_size:
            yield from flush(bucket, pending[bucket])
            pending[bucket] = []
    for b, batch in pending.items():
        yield from flush(b, batch)


def cmvn_launch_mix(lengths, batch_size: int = 8,
                    bucket_frames=CMVN_BUCKETS) -> Dict[Tuple[int, int], int]:
    """K7 launches of :func:`cmvn_full_stream` over utterances of these frame
    counts, keyed by each launch's (rows, T): a bucket's utterances in
    batches of ``batch_size`` (the tail batch padded), an utterance beyond
    the largest bucket alone at its own length."""
    per = {}
    for n in lengths:
        bucket = next((b for b in bucket_frames if n <= b), None)
        key = (batch_size, bucket) if bucket is not None else (1, n)
        per[key] = per.get(key, 0) + 1
    return {k: (c if k[0] == 1 else -(-c // batch_size)) for k, c in sorted(per.items())}


def wave_feature_stream(wav_scp: str, feat_dim: int, *, batch_size: int = 16,
                        device: Optional[Union[str, torch.device]] = None):
    """(utt, (T, F) raw FBANK tensor on ``device``) straight from a wav.scp:
    K1 batches of ``data/features.py:wave_feature_batches`` in buckets of
    WAVE_BUCKETS_S. CMVN is not applied here (see :func:`cmvn_full_stream`)."""
    from ..data.features import wave_feature_batches

    for feats, rows in wave_feature_batches(wav_scp, feat_dim, batch_size=batch_size,
                                            bucket_seconds=WAVE_BUCKETS_S, device=device):
        for i, (utt, t) in enumerate(rows):
            yield utt, feats[i, :t]


def extract_dataset(
    artifact_dir: str,
    data_dir: str,
    out_prefix: str,
    *,
    batch_size: Optional[int] = None,
    cmn_window: int = 300,
    scp_name: Optional[str] = None,
    raw: bool = False,
    progress_every: int = 2000,
    num_devices: int = 0,
    wire: str = "float32",
    cmvn: str = "device",
    device: Optional[Union[str, torch.device]] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> str:
    """Extract one embedding per utterance of a data dir into
    ``<out_prefix>.ark/.scp``; returns the scp path.

    ``raw`` streams wav.scp through K1 instead of reading
    ``scp_name`` (default ``fbank<feat_dim>.scp``). ``cmvn`` is "device"
    (K7 in bucketed batches, the plain float64 version on the CPU; the
    normalized features stay on the device for the forward) or "host"
    (``data.dataset.sliding_cmn_np`` on numpy rows). ``wire`` is the feature
    type of the forward's input ("float32" or "bfloat16"): the
    host-to-device copy of host-CMVN'd rows, a cast on the device for
    device-resident ones.

    ``num_devices`` follows the JAX CLI: 0 means every local card (one on
    the CPU), more than one splits each bucket batch into that many row
    blocks, a replica of the model a card (``eval/extract.py:
    extraction_devices``, ``sharded_embed_fn``), with the batch size rounded
    up to a multiple of it; more cards than present raises. ``devices``
    names the devices instead (e.g. ``["cpu"] * 3``, or one card twice).
    FBANK and CMVN run on the first device."""
    from .. import resolve_device
    from ..data import kaldi_io
    from ..data.dataset import sliding_cmn_np
    from ..eval.export import load_sharded_inference_artifact
    from ..eval.extract import (default_batch_size, extract_embeddings, extraction_devices,
                                make_bucketed_embed_fn, resolve_wire_dtype, round_up_batch)

    if cmvn not in ("host", "device"):
        raise ValueError(f"cmvn must be device|host, got {cmvn!r}")
    wire_dtype = resolve_wire_dtype(wire)
    if devices is None:
        devices = extraction_devices(num_devices, device)
    devices = [resolve_device(d) for d in devices]
    dev = devices[0]
    config, embed = load_sharded_inference_artifact(artifact_dir, devices)
    if batch_size is None:
        batch_size = default_batch_size(config.model)
    batch_size = round_up_batch(batch_size, len(devices))
    fn = make_bucketed_embed_fn(embed, batch_size=batch_size)

    if raw:
        stream = wave_feature_stream(os.path.join(data_dir, "wav.scp"), config.feat_dim,
                                     batch_size=batch_size, device=dev)
    else:
        scp = os.path.join(data_dir, scp_name or f"fbank{config.feat_dim}.scp")
        stream = kaldi_io.read_mat_scp(scp)
    if cmvn == "host":
        stream = ((utt, sliding_cmn_np(np.asarray(feat.cpu()) if isinstance(feat, torch.Tensor)
                                       else feat, cmn_window)) for utt, feat in stream)
    else:
        stream = cmvn_full_stream(stream, window=cmn_window, device=dev)

    def feature_stream():
        for i, (utt, feat) in enumerate(stream):
            if progress_every and i and i % progress_every == 0:
                print(f"  extract: {i} utts")
            yield utt, feat

    embeddings = extract_embeddings(fn, feature_stream(), batch_size=batch_size,
                                    wire_dtype=wire_dtype)
    ark, out_scp = out_prefix + ".ark", out_prefix + ".scp"
    with kaldi_io.ArkScpWriter(ark, out_scp) as w:
        for utt in sorted(embeddings):
            w.write(utt, embeddings[utt])
    return out_scp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True, help="inference artifact dir (cli.export output)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", required=True, help="output ark/scp path prefix")
    p.add_argument("--scp-name", default=None,
                   help="feature scp filename (default fbank<feat_dim>.scp)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="bucket batch (default 128 for w24/att Res2Nets, 64 otherwise)")
    p.add_argument("--cmn-window", type=int, default=300)
    p.add_argument("--raw", action="store_true",
                   help="stream wav.scp through FBANK on the card (no feature store)")
    p.add_argument("--num-devices", type=int, default=0,
                   help="cards to split each bucket batch over, a model replica a card (0 = "
                        "every local card; one on --device cpu, where N > 1 runs N CPU "
                        "replicas); the batch is rounded up to a multiple")
    p.add_argument("--wire", choices=("float32", "bfloat16"), default="float32",
                   help="the forward's feature type; bfloat16 halves the host-to-device "
                        "copy of host-CMVN'd features (equal for bf16-compute models, 8 "
                        "mantissa bits otherwise)")
    p.add_argument("--cmvn", choices=("device", "host"), default="device",
                   help="where sliding CMVN runs: device (K7; the default) or host "
                        "(float64 cumulative sum, the JAX package's default)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    return p


def main(argv=None) -> str:
    """Returns the xvector scp path."""
    from .. import set_float32_precision
    set_float32_precision()
    args = build_parser().parse_args(argv)
    scp = extract_dataset(
        args.artifact, args.data_dir, args.out,
        scp_name=args.scp_name, batch_size=args.batch_size,
        cmn_window=args.cmn_window, raw=args.raw,
        num_devices=args.num_devices, wire=args.wire, cmvn=args.cmvn, device=args.device,
    )
    print(f"embeddings at {scp}")
    return scp


if __name__ == "__main__":
    main()
