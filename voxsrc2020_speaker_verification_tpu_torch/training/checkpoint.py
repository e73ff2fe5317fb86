"""Checkpoint / resume of a TrainState.

The JAX package's contract, with ``torch.save`` in place of orbax:

* one directory per saved step, ``<dir>/<step>/train_state.pt``, keeping the
  newest ``max_to_keep``;
* auto-resume: restore the latest checkpoint of the experiment dir, else
  initialize fresh;
* the schedules are keyed on the restored global step. The LMFT recipe
  resumes from the pretrain experiment dir (``resume_from``), so the
  restored step lands the LR in its 1/128 tail while margin and frames
  change;
* across processes a checkpoint holds the whole model: a class-sharded
  head (and its momentum) is gathered over the model group to save, and
  process 0 alone writes; a restore reads the whole tensors and keeps this
  rank's slice. So a checkpoint written at one world size and shard count
  resumes at another, and ``cli/export.py`` reads it as any other.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import torch

from ..parallel import sharding
from .trainer import TrainState, shard_state

FILE = "train_state.pt"


class CheckpointManager:
    """Per-step checkpoints of a TrainState, newest kept."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None) -> None:
        """Every rank of the state's mesh calls it (the head's shards are
        gathered); process 0 writes."""
        step = state.step if step is None else int(step)
        params = gather_full(state.params, state.mesh)
        momentum = gather_full(state.momentum, state.mesh)
        if state.mesh.rank != 0 or step in self.all_steps():
            return
        out = os.path.join(self.directory, str(step))
        os.makedirs(out, exist_ok=True)
        tmp = os.path.join(out, FILE + ".tmp")
        torch.save({
            "step": state.step,
            "params": params,
            "batch_stats": {k: v.detach().cpu() for k, v in state.batch_stats.items()},
            "momentum": momentum,
        }, tmp)
        os.replace(tmp, os.path.join(out, FILE))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Copy a checkpoint into ``state``'s tensors (in place, on their
        device) and set its step. Returns None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        saved = torch.load(os.path.join(self.directory, str(step), FILE),
                           map_location="cpu", weights_only=True)
        for group in ("params", "momentum"):
            saved[group] = shard_state(saved[group], state.mesh)
        with torch.no_grad():
            for group, target in (("params", state.params), ("batch_stats", state.batch_stats),
                                  ("momentum", state.momentum)):
                if saved[group].keys() != target.keys():
                    raise ValueError(f"checkpoint {step}: {group} keys differ from the model's")
                for k, v in saved[group].items():
                    target[k].copy_(v)
        state.step = int(saved["step"])
        return state


def gather_full(tensors, mesh: sharding.Mesh):
    """Whole CPU copies of a state's named tensors: the class-sharded head's
    slices gathered over the model group, in class order (one all-reduce of
    a zeroed buffer each rank fills at its slot: gloo moves CUDA tensors by
    all-reduce and broadcast only)."""
    out = {}
    for name, t in tensors.items():
        t = t.detach()
        if mesh.num_model > 1 and sharding.is_projection_kernel(name):
            width = t.shape[-1]
            total = torch.tensor([width], device=t.device)
            sharding.all_reduce_(total, mesh.model_group)
            ranges = [sharding.class_range(int(total), mesh.num_model, m)
                      for m in range(mesh.num_model)]
            most = max(b - a for a, b in ranges)
            buf = t.new_zeros((mesh.num_model,) + tuple(t.shape[:-1]) + (most,))
            buf[mesh.model_rank, ..., :width] = t
            sharding.all_reduce_(buf, mesh.model_group)
            t = torch.cat([buf[m, ..., :b - a] for m, (a, b) in enumerate(ranges)], -1)
        out[name] = t.cpu()
    return out


def restore_or_init(state: TrainState, exp_dir: str, resume_from: Optional[str] = None,
                    max_to_keep: Optional[int] = None) -> Tuple[TrainState, CheckpointManager]:
    """1. the latest checkpoint in ``exp_dir``; 2. else the latest in
    ``resume_from`` (LMFT: the global step continues); 3. else ``state`` as
    it is. Returns (state, the manager of exp_dir)."""
    mgr = CheckpointManager(exp_dir, max_to_keep=max_to_keep)
    if mgr.restore(state) is not None:
        return state, mgr
    if resume_from is not None and os.path.isdir(resume_from):
        CheckpointManager(resume_from).restore(state)
    return state, mgr
