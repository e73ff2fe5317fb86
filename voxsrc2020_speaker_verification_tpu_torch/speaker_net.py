"""SpeakerNet: the encoder whose eval-mode embeddings the artifact serves.

The training net (``training/speaker_net.py``) extends it with the margin
projection head; the served model is the encoder alone, and the projection
rows travel as ``projection_weight.pkl``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from . import resolve_device
from .config import TrainConfig
from .models import get_model


class SpeakerNet(nn.Module):
    def __init__(self, model_name: str = "res2net50_w24_s4_c32",
                 feat_dim: int = 80, dtype: Optional[torch.dtype] = None, **remat):
        """``remat``: the model's rematerialization options (``remat``,
        ``remat_policy``, ``remat_stages``, ``remat_keep_blocks``)."""
        super().__init__()
        self.encoder = get_model(model_name, dtype=dtype, feat_dim=feat_dim, **remat)

    def embed(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inference-mode embeddings (B, D), float32."""
        return self.encoder(feats, False, mask).float()


def build_speaker_net(config: TrainConfig,
                      device: Optional[Union[str, torch.device]] = None) -> SpeakerNet:
    """The config's model in eval mode on ``device`` (default ``cuda``);
    bfloat16 compute when ``config.bf16``, as the JAX trainer builds it."""
    dev = resolve_device(device)
    net = SpeakerNet(config.model, config.feat_dim,
                     torch.bfloat16 if config.bf16 else None)
    return net.to(dev).eval()
