"""Inference artifacts of the port.

An artifact directory holds:

* ``config.json`` -- the TrainConfig fields plus ``step``, the same schema
  as the JAX package's artifacts;
* ``weights.pt`` -- the SpeakerNet state_dict (float32, CPU tensors);
* ``projection_weight.pkl`` -- optional cohort rows for asnorm: the
  classifier kernel [K, emb, C] -> swapaxes(-1, -2) -> (K*C, emb) ->
  row-l2norm.

``export_inference_artifact`` writes one from a training state, always with
``projection_weight.pkl``. A JAX artifact (orbax ``variables/``) converts
with ``scripts/jax_artifact_to_torch.py``, which runs where JAX is installed
(``convert.from_flax``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import resolve_device
from ..config import TrainConfig
from ..speaker_net import build_speaker_net
from .scoring import l2norm


def export_projection_weights(params, path: Optional[str] = None) -> np.ndarray:
    """Classifier rows as cohort embeddings."""
    kernel = np.asarray(params["projection"]["kernel"], np.float32)
    w = np.swapaxes(kernel, -1, -2).reshape(-1, kernel.shape[-2])
    w = l2norm(w, axis=1)
    if path:
        with open(path, "wb") as f:
            pickle.dump(w, f)
    return w


def save_inference_artifact(
    config: TrainConfig,
    state_dict: Dict[str, torch.Tensor],
    out_dir: str,
    *,
    projection_params=None,
    step: int = 0,
) -> str:
    """Write config.json, weights.pt and (with ``projection_params``, a
    ``{"projection": {"kernel": (K, emb, C)}}`` dict) projection_weight.pkl."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({**dataclasses.asdict(config), "step": int(step)}, f, indent=2)
    torch.save({k: v.detach().float().cpu() for k, v in state_dict.items()},
               os.path.join(out_dir, "weights.pt"))
    if projection_params is not None:
        export_projection_weights(
            projection_params, os.path.join(out_dir, "projection_weight.pkl"))
    return out_dir


def export_inference_artifact(config: TrainConfig, state, out_dir: str) -> str:
    """Write the artifact of a training ``TrainState``
    (``training/trainer.py``): the encoder's weights, the config with the
    state's step, and the projection rows as ``projection_weight.pkl``.

    The JAX package's version can also serialize StableHLO embed functions
    per bucket shape (``stablehlo_buckets``); the port has no counterpart
    (ROADMAP.md)."""
    sd = {k: v for k, v in state.net.state_dict().items() if k.startswith("encoder.")}
    kernel = state.net.projection.kernel.detach().float().cpu().numpy()
    return save_inference_artifact(config, sd, out_dir,
                                   projection_params={"projection": {"kernel": kernel}},
                                   step=state.step)


def load_inference_artifact(
    artifact_dir: str, device: Optional[Union[str, torch.device]] = None
):
    """-> (config, embed_fn(feats (B, T, F), mask (B, T)) -> (B, D) float32
    tensor on ``device``, default ``cuda``). ``feats`` may be float32 or the
    bf16 wire; it is upcast to float32 on the device. The embed runs under
    ``torch.inference_mode`` in whatever thread calls it."""
    dev = resolve_device(device)
    config = TrainConfig.from_json(os.path.join(artifact_dir, "config.json"))
    net = build_speaker_net(config, dev)
    state = torch.load(os.path.join(artifact_dir, "weights.pt"),
                       map_location=dev, weights_only=True)
    net.load_state_dict(state)

    def embed(feats, mask):
        with torch.inference_mode():
            f = torch.as_tensor(feats).to(dev, non_blocking=True).float()
            m = torch.as_tensor(mask).to(dev, non_blocking=True).float()
            return net.embed(f, m)

    return config, embed


def load_sharded_inference_artifact(artifact_dir: str,
                                    devices: Sequence[Union[str, torch.device]]):
    """-> (config, embed_fn) over one replica of the artifact a device of
    ``devices`` (``eval/extract.py:sharded_embed_fn``): a batch's rows are
    split into ``len(devices)`` contiguous blocks, one a device, and come
    back in order. One device gives :func:`load_inference_artifact`'s
    embed fn."""
    from .extract import sharded_embed_fn

    loaded = [load_inference_artifact(artifact_dir, d) for d in devices]
    return loaded[0][0], sharded_embed_fn([embed for _, embed in loaded])
