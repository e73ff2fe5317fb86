"""Train a speaker-embedding model with the PyTorch port (feature-fed).

    # pretrain from a Kaldi feature store, on the GPU (the default device):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_vox2_dev_aug --model res2net50_w8_s6_c16 \\
        --data-root data

    # LMFT finetune (resumes from the pretrain experiment dir), 600-frame
    # crops with stages 0-2 rematerialized:
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_finetune_vox2_dev --model res2net50_w8_s6_c16 \\
        --data-root data --batch-size 256 --num-accumulation-steps 4 \\
        --bn-groups 16 --remat-stages 0 1 2

    # throughput run without data:
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_vox2_dev_aug --synthetic --max-steps 50 --no-checkpoint

    # raw-audio training from <data-root>/<dataset>/wav.scp (plain wavs or
    # JSON augmentation specs) and utt2id.pkl: FBANK (K1, dithered) and
    # sliding CMN (K7) inside the train step
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_vox2_dev_aug --model res2net50_w8_s6_c16 \\
        --data-root data --raw

    # ECAPA-TDNN with SpecAugment:
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe ecapa_vox2_dev_aug --data-root data --specaug

    # the plain PyTorch path on the CPU (small shapes):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_vox2_dev_aug --data-root data --device cpu \\
        --batch-size 4 --num-accumulation-steps 2 --feat-length 32 \\
        --max-steps 2 --no-checkpoint

    # the reference's best system on one card, at the shape measured to fit
    # it (recipes.SINGLE_CHIP_SHAPES):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.train \\
        --recipe res2net_vox2_dev_aug --model res2net200_w24_s4_c32_att \\
        --data-root data --single-chip

    # two processes (cli/launch.py spawns them): the batch split over data
    # ranks, or with --num-model-shards 2 the head's classes split
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.launch \\
        --num-processes 2 -- --recipe res2net_vox2_dev_aug --data-root data

The feature store is ``<data-root>/<dataset>/``: ``utt2id.pkl`` and the
``{N}-split/feats.{i}.scp`` shards of CM-compressed arks. The C++ feeder
(``data/native.py``, built from ``native/``) reads it unless
``--no-native-feeder`` or the library cannot be built; the Python feeder
(``FeatureShardDataset`` + ``BatchFeeder``) then does. With ``--raw`` the
data is ``<data-root>/<dataset>/wav.scp`` and ``utt2id.pkl``, read by the
C++ raw feeder (``NativeRawBatchFeeder``) or the Python one
(``RawAudioShardDataset`` + ``BatchFeeder``). The CLI prints which feeder
ran.

Across processes (``--coordinator``, ``--process-id``, ``--num-processes``;
``cli/launch.py`` passes them) the ranks form a (data, model) layout
(``parallel/``, ``--num-model-shards`` model ranks): each process feeds
``batch_size / data ranks`` rows a microbatch from its data rank's shards
(``--synthetic``: every rank draws the global batch from the same seeds
and keeps its block, so ``--num-workers 1`` gives every world size the same
rows) and runs on ``cuda:(process_id % device_count)``. The backend is NCCL
where every process has its own card, gloo where processes share one (NCCL
refuses two ranks on one device) or on ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

from ..recipes import RECIPES, get_recipe, single_chip_shape


@dataclasses.dataclass
class TrainRun:
    """What ``main`` ran: the fit result, the feeder (``"native"``,
    ``"python"`` or ``"synthetic"``) and its decode errors at the end."""
    result: object
    feeder: str
    decode_errors: int


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    p.add_argument("--model", default=None, help="model id override")
    p.add_argument("--data-root", default="data")
    p.add_argument("--exp-root", default="exp")
    p.add_argument("--num-shards", type=int, default=32,
                   help="which {N}-split scp sharding to read")
    p.add_argument("--synthetic", action="store_true",
                   help="random data, no IO (throughput runs)")
    p.add_argument("--raw", action="store_true",
                   help="raw-audio mode: wav.scp crops, FBANK + CMN in the train step")
    p.add_argument("--num-workers", type=int, default=None,
                   help="feeder threads (and synthetic sources); default min(4, host "
                        "cores), 4 across processes")
    p.add_argument("--no-native-feeder", action="store_true",
                   help="the Python feeder even where the C++ one builds")
    p.add_argument("--cmvn-pkl", default=None,
                   help="global CMVN (mean, std) pickle applied after sliding CMN")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--save-every-steps", type=int, default=None,
                   help="mid-epoch checkpoint cadence (per-epoch checkpoints always happen)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    # config overrides
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-accumulation-steps", type=int, default=None)
    p.add_argument("--bn-groups", type=int, default=None,
                   help="training-BN batch groups (per-replica statistics)")
    p.add_argument("--total-epochs", type=int, default=None)
    p.add_argument("--margin", type=float, default=None)
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--feat-length", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--dataset-length", type=int, default=None)
    p.add_argument("--remat", action="store_true", default=None,
                   help="per-block rematerialization")
    p.add_argument("--remat-stages", type=int, nargs="+", default=None,
                   help="rematerialize only these 0-based stages (implies --remat)")
    p.add_argument("--specaug", action="store_true",
                   help="SpecAugment: one time and one frequency mask per utterance")
    p.add_argument("--float32", action="store_true",
                   help="compute in float32 (the recipes' bf16 off)")
    p.add_argument("--print-kernel-launches", action="store_true",
                   help="print this process's CUDA kernel launches by entry point at the end")
    p.add_argument("--remat-policy", default=None,
                   help="what a checkpoint keeps, by jax.checkpoint_policies name "
                        "(implies --remat; models/res2net.py:REMAT_POLICIES)")
    p.add_argument("--single-chip", action="store_true",
                   help="the recipe model's measured single-H100 shape (microbatch, "
                        "accumulation, remat, bn_groups; recipes.SINGLE_CHIP_SHAPES)")
    p.add_argument("--num-model-shards", type=int, default=1,
                   help="model ranks: the margin head's classes split over them")
    # multi-process bootstrap (torch.distributed; cli/launch.py sets these)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0; enables torch.distributed")
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--num-processes", type=int, default=1)
    return p


def init_distributed(args, device):
    """torch.distributed for this process, or None for one process:
    (backend, the device this process runs on). NCCL where every process has
    its own card, gloo where processes share one or on the CPU."""
    import torch
    import torch.distributed as dist

    if args.num_processes == 1 and args.coordinator is None:
        return None, device
    if args.coordinator is None:
        raise SystemExit("--num-processes > 1 needs --coordinator host:port")
    if device.type == "cuda":
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl" if args.num_processes <= torch.cuda.device_count() else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{args.coordinator}",
                            world_size=args.num_processes, rank=args.process_id)
    return backend, device


def main(argv=None) -> Optional[TrainRun]:
    from .. import resolve_device, set_float32_precision
    set_float32_precision()
    p = build_parser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not 0 <= args.process_id < args.num_processes:
        p.error(f"--process-id {args.process_id} outside 0..{args.num_processes - 1}")
    if args.num_processes % args.num_model_shards:
        p.error(f"--num-model-shards {args.num_model_shards} does not divide "
                f"--num-processes {args.num_processes}")
    if args.cmvn_pkl and (args.raw or args.synthetic):
        p.error("--cmvn-pkl applies to the feature-store path only (not --raw or "
                "--synthetic)")
    from ..utils import resolve_num_workers
    if args.num_workers is None and args.num_processes > 1:
        # as the JAX CLI: a host-independent default, so every rank derives
        # the same global sharding of the raw Python feeder
        args.num_workers = 4
    num_workers = resolve_num_workers(args.num_workers)
    if num_workers < 1:
        p.error("--num-workers must be >= 1")

    remat = args.remat or args.remat_stages is not None or args.remat_policy is not None
    overrides = {k: v for k, v in {
        "batch_size": args.batch_size,
        "num_accumulation_steps": args.num_accumulation_steps,
        "bn_groups": args.bn_groups,
        "total_epochs": args.total_epochs,
        "margin": args.margin,
        "scale": args.scale,
        "feat_length": args.feat_length,
        "base_lr": args.base_lr,
        "dataset": args.dataset,
        "num_classes": args.num_classes,
        "dataset_length": args.dataset_length,
        # --remat-stages / --remat-policy imply --remat: the model checkpoints
        # only with remat set, so a bare --remat-stages would do nothing
        "remat": remat or None,
        "remat_stages": None if args.remat_stages is None else tuple(args.remat_stages),
        "remat_policy": args.remat_policy,
    }.items() if v is not None}
    # as the JAX package's CLI: the flag decides, whatever the recipe says
    overrides.update(exp_root=args.exp_root, seed=args.seed, raw_audio=args.raw,
                     specaug=args.specaug, num_model_shards=args.num_model_shards)
    if args.float32:
        overrides["bf16"] = False
    config, resume_from = get_recipe(args.recipe, model=args.model,
                                     single_chip=args.single_chip, **overrides)
    if resume_from is not None and resume_from.startswith("exp/"):
        resume_from = os.path.join(args.exp_root, *resume_from.split("/")[1:])

    from ..data import native
    from ..data.dataset import (BatchFeeder, FeatureShardDataset, RowBlock, SyntheticDataset,
                                shard_paths_for_host)
    from ..parallel import Mesh, batch_spec, make_mesh
    from ..training.loop import fit
    from ..utils.datadir import load_utt2id

    backend, device = init_distributed(args, device)
    mesh = make_mesh(num_model=args.num_model_shards) if backend else Mesh()
    if backend and mesh.rank == 0:
        print(f"distributed: {backend}, {mesh.num_data} data x {mesh.num_model} model "
              f"ranks", flush=True)
    if args.single_chip:
        print(f"single-chip shape: {single_chip_shape(config.model, config.feat_length)} "
              f"-> batch {config.batch_size} x {config.num_accumulation_steps}, "
              f"bn_groups {config.bn_groups}, remat {config.remat} {config.remat_stages}",
              flush=True)
    start, stop = batch_spec(mesh, config.batch_size)
    local_batch = stop - start
    data_rank, num_data = mesh.data_rank, mesh.num_data
    seed = args.seed + 1000 * data_rank
    use_native = not args.no_native_feeder and native.available()
    if args.synthetic:
        kind = "synthetic"
        # every rank draws the global batch and keeps its block of rows
        feeder = RowBlock(BatchFeeder(
            [SyntheticDataset(config.feat_dim, config.feat_length, config.num_classes,
                              seed=args.seed + i) for i in range(num_workers)],
            config.batch_size, config.num_accumulation_steps).start(), start, stop)
    elif args.raw:
        from ..data.raw_dataset import RawAudioShardDataset
        from ..ops.fbank import FbankConfig

        data_dir = os.path.join(args.data_root, config.dataset)
        utt2id = load_utt2id(os.path.join(data_dir, "utt2id.pkl"))
        wav_scp = os.path.join(data_dir, "wav.scp")
        cfg = FbankConfig(num_bins=config.feat_dim)
        if use_native:
            # wav decode, spec rendering, int16 crop and assembly in the C++
            # thread pool, one ctypes call per optimizer step
            kind = "native"
            feeder = native.NativeRawBatchFeeder(
                wav_scp, utt2id, config.feat_length, local_batch,
                config.num_accumulation_steps, cfg=cfg, context=config.cmn_context,
                num_threads=num_workers, seed=seed, shard_index=data_rank,
                num_shards=num_data).start()
        else:
            kind = "python"
            feeder = BatchFeeder(
                [RawAudioShardDataset(wav_scp, utt2id, config.feat_length, cfg=cfg,
                                      context=config.cmn_context,
                                      shard_index=data_rank * num_workers + i,
                                      num_shards=num_data * num_workers, seed=seed + i)
                 for i in range(num_workers)],
                local_batch, config.num_accumulation_steps).start()
        workers = f"{num_workers} {'threads' if kind == 'native' else 'sources'}"
        print(f"feeder: {kind} (raw, {wav_scp}, {workers})", flush=True)
    else:
        data_dir = os.path.join(args.data_root, config.dataset)
        utt2id = load_utt2id(os.path.join(data_dir, "utt2id.pkl"))
        paths = shard_paths_for_host(data_dir, args.num_shards, data_rank, num_data)
        if use_native:
            # the whole hot loop (ark decode, CMN, crop, assembly, bf16 wire)
            # in the C++ thread pool, one ctypes call per optimizer step
            kind = "native"
            feeder = native.NativeBatchFeeder(
                paths, utt2id, config.feat_dim, config.feat_length, local_batch,
                config.num_accumulation_steps, num_threads=num_workers, seed=seed,
                wire_bf16=config.bf16, cmvn_pkl=args.cmvn_pkl).start()
        else:
            kind = "python"
            feeder = BatchFeeder(
                [FeatureShardDataset(path, utt2id, config.feat_dim, config.feat_length,
                                     cmvn_pkl=args.cmvn_pkl, seed=seed + i)
                 for i, path in enumerate(paths)],
                local_batch, config.num_accumulation_steps,
                # bf16 compute: the bf16 wire is lossless and halves the copy
                wire_bf16=config.bf16).start()
        workers = (f"{num_workers} threads" if kind == "native"
                   else f"{len(paths)} sources")
        print(f"feeder: {kind} ({len(paths)} shards of {data_dir}, {workers})", flush=True)
    try:
        result = fit(config, feeder, resume_from=resume_from, log_every=args.log_every,
                     max_steps=args.max_steps, checkpoint=not args.no_checkpoint,
                     save_every_steps=args.save_every_steps, device=device, mesh=mesh)
        errors = feeder.decode_errors() if hasattr(feeder, "decode_errors") else 0
        if result.preempted:
            print(f"preempted at step {result.state.step} (checkpoint saved)")
        print(f"done: {result.steps_run} steps, "
              f"{result.audio_seconds_per_second:.0f} audio-s/s")
        if args.print_kernel_launches:
            import json

            from ..kernels import function_launch_counts
            print("kernel launches: " + json.dumps(
                {k: v for k, v in function_launch_counts().items() if v}), flush=True)
    finally:
        feeder.stop()
        if backend:
            import torch.distributed as dist
            dist.destroy_process_group()
    return TrainRun(result=result, feeder=kind, decode_errors=errors)


if __name__ == "__main__":
    main()
