"""Recipe registry of the port: the JAX package's recipes, as configuration.

Each recipe returns ``(TrainConfig, resume_from)``; ``resume_from`` is the
pretrain experiment dir of an LMFT finetune, whose restored global step
lands the LR in its 1/128 tail. Every reference-parity recipe sets
``bn_groups=8``: BN statistics per group of ``batch_size / 8`` examples, the
reference's per-replica BN at world size 8. ``_apply`` falls back to the
largest feasible group count when a smoke run overrides the batch below it.

Every recipe's default model is ported. ``get_recipe(single_chip=True)``
(``cli/train.py --single-chip``) applies the single-card shape of the
recipe's model from :data:`SINGLE_CHIP_SHAPES`, measured on an H100 (the
JAX package's table holds TPU v5e shapes; its keys and its override rule
are kept).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from ..config import TrainConfig

VOX2_DEV_UTTS = 1_092_009   # ref run_res2net_local_vox2_dev_aug.sh:32
VOX2_DEV_SPEAKERS = 5994
VOX1_DEV_UTTS = 148_642     # ref scripts_for_40.../run_tdnn_local_voxsrc2020_vox1_dev_aug.sh:33
VOX1_DEV_SPEAKERS = 1211

RecipeFn = Callable[..., Tuple[TrainConfig, Optional[str]]]
RECIPES: Dict[str, RecipeFn] = {}


def recipe(name: str):
    def wrap(fn: RecipeFn) -> RecipeFn:
        RECIPES[name] = fn
        return fn
    return wrap


def _apply(config: TrainConfig, overrides) -> TrainConfig:
    if overrides:
        config = dataclasses.replace(config, **overrides)
    if config.batch_size % config.bn_groups:
        # batch overridden below the recipe's group count (smoke runs):
        # keep per-replica semantics at the largest feasible group count
        import math
        config = dataclasses.replace(
            config, bn_groups=math.gcd(config.batch_size, config.bn_groups))
    return config


@recipe("res2net_vox2_dev_aug")
def res2net_vox2_dev_aug(model: str = "res2net50_w24_s4_c64", **overrides):
    """Pretrain on 5x-augmented VoxCeleb2-dev (ref run_res2net_local_vox2_dev_aug.sh:19-43)."""
    cfg = TrainConfig(
        model=model, projection="sc_cm_linear", scale=32.0, margin=0.2,
        num_classes=VOX2_DEV_SPEAKERS, dataset="voxceleb2_dev_aug",
        dataset_length=VOX2_DEV_UTTS * 5, feat_dim=80, feat_length=200,
        batch_size=256, num_accumulation_steps=4, total_epochs=23,
        bn_groups=8,
    )
    return _apply(cfg, overrides), None


@recipe("res2net_finetune_vox2_dev")
def res2net_finetune_vox2_dev(model: str = "res2net50_w24_s4_c64", **overrides):
    """LMFT: continue from the pretrain dir at margin 0.4 / 600 frames on
    non-augmented data; dataset_length deliberately stays 5x (ref
    run_res2net_finetune_local_vox2_dev.sh:30-46) so total_epochs=24 yields
    exactly one extra epoch at LR/128."""
    pretrain, _ = res2net_vox2_dev_aug(model)
    cfg = dataclasses.replace(
        pretrain, dataset="voxceleb2_dev", margin=0.4, feat_length=600,
        batch_size=128, num_accumulation_steps=8, total_epochs=24,
    )
    return _apply(cfg, overrides), pretrain.exp_dir


@recipe("dpn_vox2_dev_aug")
def dpn_vox2_dev_aug(model: str = "dpn68", **overrides):
    """ref run_dpn_local_vox2_dev_aug.sh:19-43."""
    return res2net_vox2_dev_aug(model, **overrides)


@recipe("dpn_finetune_vox2_dev")
def dpn_finetune_vox2_dev(model: str = "dpn68", **overrides):
    """ref run_dpn_finetune_local_vox2_dev.sh:30-53."""
    return res2net_finetune_vox2_dev(model, **overrides)


def _voxsrc2020(model, _dataset, _dataset_length, _num_classes, **overrides):
    cfg = TrainConfig(
        model=model, projection="cm_linear_voxsrc2020", scale=32.0, margin=0.2,
        num_classes=_num_classes, dataset=_dataset, dataset_length=_dataset_length,
        feat_dim=40, feat_length=320,
        batch_size=1024, num_accumulation_steps=1, total_epochs=23,
        bn_groups=8,
    )
    return _apply(cfg, overrides), None


@recipe("tdnn_voxsrc2020_vox2_dev_aug")
def tdnn_voxsrc2020_vox2_dev_aug(model: str = "tdnn", **overrides):
    """40-d / 320-frame VoxSRC2020 track (ref scripts_for_40.../run_tdnn_local_voxsrc2020_vox2_dev_aug.sh)."""
    return _voxsrc2020(model, "voxceleb2_dev_aug", VOX2_DEV_UTTS * 5,
                       VOX2_DEV_SPEAKERS, **overrides)


@recipe("tdnn_voxsrc2020_vox2_dev")
def tdnn_voxsrc2020_vox2_dev(model: str = "tdnn", **overrides):
    """Non-aug variant; dataset_length stays 5x per the reference script
    (ref scripts_for_40.../run_tdnn_local_voxsrc2020_vox2_dev.sh:32-34)."""
    return _voxsrc2020(model, "voxceleb2_dev", VOX2_DEV_UTTS * 5,
                       VOX2_DEV_SPEAKERS, **overrides)


@recipe("tdnn_voxsrc2020_vox1_dev_aug")
def tdnn_voxsrc2020_vox1_dev_aug(model: str = "tdnn", **overrides):
    """VoxCeleb1-dev 1211-class variant (ref scripts_for_40.../run_tdnn_local_voxsrc2020_vox1_dev_aug.sh:32-34)."""
    return _voxsrc2020(model, "voxceleb1_dev_aug", VOX1_DEV_UTTS * 5,
                       VOX1_DEV_SPEAKERS, **overrides)


@recipe("ecapa_vox2_dev_aug")
def ecapa_vox2_dev_aug(model: str = "ecapa_tdnn_512", **overrides):
    """Framework extension (no reference counterpart): ECAPA-TDNN on
    5x-augmented VoxCeleb2-dev with AAM-softmax (arXiv:2005.07143 §3 uses
    AAM s=30 m=0.2; we keep this framework's s=32 and margin schedule)."""
    cfg = TrainConfig(
        model=model, projection="aam_linear", scale=32.0, margin=0.2,
        num_classes=VOX2_DEV_SPEAKERS, dataset="voxceleb2_dev_aug",
        dataset_length=VOX2_DEV_UTTS * 5, feat_dim=80, feat_length=200,
        batch_size=256, num_accumulation_steps=4, total_epochs=23,
        specaug=True,
    )
    return _apply(cfg, overrides), None


@recipe("dpn_voxsrc2020_vox2_dev_aug")
def dpn_voxsrc2020_vox2_dev_aug(model: str = "dpn68", **overrides):
    """ref scripts_for_40.../run_dpn_local_voxsrc2020_vox2_dev_aug.sh."""
    return _voxsrc2020(model, "voxceleb2_dev_aug", VOX2_DEV_UTTS * 5,
                       VOX2_DEV_SPEAKERS, **overrides)


# The fastest measured shape of each (model, frames) on one NVIDIA H100 80GB
# HBM3 (700 W): the most rows per second, at an effective batch of 1024,
# among the microbatches whose peak memory leaves 10% of the card free,
# without rematerialization where one fits so (scripts/encoder_memory.py
# --single-chip; its output, with every shape tried and its peak and step
# time, is single_chip_h100.json beside this file). bn_groups keeps a BN
# group at the JAX table's rows (recipes/__init__.py:161-170 there): 32 on
# the f200 pretrain legs, 16 on the f600 LMFT legs, 128 for the TDNN.
SINGLE_CHIP_SHAPES = {
    ("res2net50_w8_s6_c16", 200): dict(
        batch_size=512, num_accumulation_steps=2, remat=False, remat_stages=None,
        bn_groups=16),  # 45.72 GB, 347.7 ms a microbatch
    ("res2net50_w8_s6_c16", 600): dict(
        batch_size=256, num_accumulation_steps=4, remat=False, remat_stages=None,
        bn_groups=16),  # 68.41 GB, 511.6 ms a microbatch
    ("res2net50_w24_s4_c64", 200): dict(
        batch_size=256, num_accumulation_steps=4, remat=False, remat_stages=None,
        bn_groups=8),  # 62.04 GB, 337.0 ms a microbatch
    ("res2net50_w24_s4_c64", 600): dict(
        batch_size=64, num_accumulation_steps=16, remat=False, remat_stages=None,
        bn_groups=4),  # 46.63 GB, 255.5 ms a microbatch
    ("res2net50_w24_s4_c32", 200): dict(
        batch_size=256, num_accumulation_steps=4, remat=False, remat_stages=None,
        bn_groups=8),  # 44.59 GB, 270.5 ms a microbatch
    ("res2net50_w24_s4_c32", 600): dict(
        batch_size=128, num_accumulation_steps=8, remat=False, remat_stages=None,
        bn_groups=8),  # 66.68 GB, 397.2 ms a microbatch
    ("res2net101_w24_s4_c32_att", 200): dict(
        batch_size=256, num_accumulation_steps=4, remat=False, remat_stages=None,
        bn_groups=8),  # 67.93 GB, 375.4 ms a microbatch
    ("res2net101_w24_s4_c32_att", 600): dict(
        batch_size=64, num_accumulation_steps=16, remat=False, remat_stages=None,
        bn_groups=4),  # 51.07 GB, 288.4 ms a microbatch
    ("res2net152_w24_s4_c32_att", 200): dict(
        batch_size=128, num_accumulation_steps=8, remat=False, remat_stages=None,
        bn_groups=4),  # 48.73 GB, 269.5 ms a microbatch
    ("res2net152_w24_s4_c32_att", 600): dict(
        batch_size=64, num_accumulation_steps=16, remat=False, remat_stages=None,
        bn_groups=4),  # 72.67 GB, 386.1 ms a microbatch
    ("res2net200_w24_s4_c32_att", 200): dict(
        batch_size=128, num_accumulation_steps=8, remat=False, remat_stages=None,
        bn_groups=4),  # 70.54 GB, 374.3 ms a microbatch
    ("res2net200_w24_s4_c32_att", 600): dict(
        batch_size=32, num_accumulation_steps=32, remat=False, remat_stages=None,
        bn_groups=2),  # 53.05 GB, 298.0 ms a microbatch
    ("dpn68", 200): dict(
        batch_size=256, num_accumulation_steps=4, remat=False, remat_stages=None,
        bn_groups=8),  # 61.59 GB, 349.4 ms a microbatch
    ("dpn68", 600): dict(
        batch_size=64, num_accumulation_steps=16, remat=False, remat_stages=None,
        bn_groups=4),  # 46.29 GB, 263.9 ms a microbatch
    ("tdnn", 320): dict(
        batch_size=1024, num_accumulation_steps=1, remat=False, remat_stages=None,
        bn_groups=8),  # 5.92 GB, 25.6 ms a microbatch
}


def single_chip_shape(model: str, feat_length: int) -> dict:
    """The measured single-H100 overrides (batch, accumulation, remat,
    bn_groups) of a model at a crop length, or {} where none was measured."""
    return dict(SINGLE_CHIP_SHAPES.get((model, feat_length), {}))


def get_recipe(name: str, model: Optional[str] = None, single_chip: bool = False,
               **overrides):
    """``(config, resume_from)`` of a recipe, with ``overrides``; with
    ``single_chip`` the model's :func:`single_chip_shape` under them. The
    JAX package's rule: explicit overrides win over the table, and
    batch_size and num_accumulation_steps are one shape -- pinning either
    drops both table keys, or a partial merge would change the effective
    batch (and with it the step counts and the schedules)."""
    fn = RECIPES[name]
    config, resume = fn(model, **overrides) if model else fn(**overrides)
    if single_chip:
        shape = single_chip_shape(config.model, config.feat_length)
        if {"batch_size", "num_accumulation_steps"} & set(overrides):
            shape.pop("batch_size", None)
            shape.pop("num_accumulation_steps", None)
        shape = {k: v for k, v in shape.items() if k not in overrides}
        if shape:
            config = _apply(config, shape)
    return config, resume
