"""Checkpoint / resume of a TrainState.

The JAX package's contract, with ``torch.save`` in place of orbax:

* one directory per saved step, ``<dir>/<step>/train_state.pt``, keeping the
  newest ``max_to_keep``;
* auto-resume: restore the latest checkpoint of the experiment dir, else
  initialize fresh;
* the schedules are keyed on the restored global step. The LMFT recipe
  resumes from the pretrain experiment dir (``resume_from``), so the
  restored step lands the LR in its 1/128 tail while margin and frames
  change.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import torch

from .trainer import TrainState

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
        step = state.step if step is None else int(step)
        if step in self.all_steps():
            return
        out = os.path.join(self.directory, str(step))
        os.makedirs(out, exist_ok=True)
        tmp = os.path.join(out, FILE + ".tmp")
        torch.save({
            "step": state.step,
            "params": {k: v.detach().cpu() for k, v in state.params.items()},
            "batch_stats": {k: v.detach().cpu() for k, v in state.batch_stats.items()},
            "momentum": {k: v.detach().cpu() for k, v in state.momentum.items()},
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
        with torch.no_grad():
            for group, target in (("params", state.params), ("batch_stats", state.batch_stats),
                                  ("momentum", state.momentum)):
                if saved[group].keys() != target.keys():
                    raise ValueError(f"checkpoint {step}: {group} keys differ from the model's")
                for k, v in saved[group].items():
                    target[k].copy_(v)
        state.step = int(saved["step"])
        return state


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
