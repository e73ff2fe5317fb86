"""Typed training/model configuration, the JAX-free twin of the reference
package's ``training/config.py``.

It reads and writes the same ``config.json`` schema, so an artifact's config
loads in either package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model / loss
    model: str = "res2net50_w24_s4_c32"
    projection: str = "sc_cm_linear"
    num_classes: int = 5994
    num_centers: int = 2
    scale: float = 32.0
    margin: float = 0.2

    # data
    dataset: str = "voxceleb2_dev_aug"
    dataset_length: int = 5_460_045
    feat_dim: int = 80
    feat_length: int = 200

    # optimization (effective global batch = batch_size * num_accumulation_steps)
    batch_size: int = 256
    num_accumulation_steps: int = 4
    total_epochs: int = 23
    momentum: float = 0.9
    clip_norm: float = 1.0
    l2_scale: float = 1e-3
    base_lr: Optional[float] = None  # default: 0.08/128 * effective batch
    lr_schedule: str = "exp"  # "exp" | "cosine"
    lr_boundaries_epochs: tuple = (3, 13, 23)
    margin_boundaries_epochs: tuple = (3, 13)
    decay_rate: float = 0.5

    # precision / regularization
    bf16: bool = True  # compute dtype bfloat16 (params stay float32)
    specaug: bool = False
    remat: bool = False
    remat_stages: Optional[tuple] = None
    remat_policy: Optional[str] = None
    remat_keep_blocks: Optional[tuple] = None
    bn_groups: int = 1

    # raw-audio mode
    raw_audio: bool = False
    dither: float = 1.0
    cmn_window: int = 300
    cmn_context: int = 150

    # parallelism
    num_model_shards: int = 1

    # io
    exp_root: str = "exp"
    seed: int = 0

    @property
    def effective_batch(self) -> int:
        return self.batch_size * self.num_accumulation_steps

    @property
    def epoch_size(self) -> int:
        """Optimizer steps per epoch."""
        return self.dataset_length // self.effective_batch

    @property
    def total_steps(self) -> int:
        return self.epoch_size * self.total_epochs

    @property
    def learning_rate(self) -> float:
        if self.base_lr is not None:
            return self.base_lr
        return 0.08 / 128.0 * self.effective_batch

    @property
    def exp_name(self) -> str:
        return (
            f"{self.model}_{self.projection}_frames{self.feat_length}"
            f"_scale{self.scale:g}_margin{self.margin:g}"
        )

    @property
    def exp_dir(self) -> str:
        return f"{self.exp_root}/{self.dataset}/{self.exp_name}"

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            raw = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in raw.items() if k in names
        })
