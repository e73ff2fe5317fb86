"""SpeakerNet for training: the encoder plus the margin projection.

It extends the serving ``SpeakerNet`` (``speaker_net.py``) with
``projection.kernel``, so the state_dict is the serving one plus that key:
the encoder entries of a trained net load into the serving net with
``strict=True``. ``bn_groups`` > 1 computes training BN statistics over that
many equal batch groups (the reference's per-replica BN); ``remat``
keywords go to the encoder (``models.get_model``). ``class_range`` makes
the projection one class shard of a head split over a model group
(``parallel/``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..losses import MarginProjection
from ..parallel.sharding import active_mesh, sum_gradients
from ..speaker_net import SpeakerNet as EmbeddingNet


class SpeakerNet(EmbeddingNet):
    def __init__(self, model_name: str = "res2net50_w24_s4_c32",
                 projection_id: str = "sc_cm_linear", num_classes: int = 5994,
                 num_centers: int = 2, feat_dim: int = 80,
                 dtype: Optional[torch.dtype] = None, bn_groups: int = 1,
                 class_range: Optional[Tuple[int, int]] = None, **remat):
        super().__init__(model_name, feat_dim, dtype, **remat)
        self.encoder.set_bn_groups(bn_groups)
        self.projection = MarginProjection(
            self.encoder.config.output_dim, num_classes, projection_id, num_centers,
            class_range=class_range)

    def forward(self, feats: torch.Tensor, labels: torch.Tensor, scale: float,
                margin: float, training: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embeddings in the compute dtype, float32 scaled logits)."""
        emb = self.encoder(feats, training)
        return emb, self.projection(emb, labels, scale, margin)

    def loss(self, feats: torch.Tensor, labels: torch.Tensor, scale: float,
             margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward to the per-row cross-entropy and correct flags
        (``MarginProjection.cross_entropy``), both (B,) float32. Inside a
        step whose mesh has model ranks, the embedding's gradient is summed
        over the model group (each rank's head gives its classes' share)."""
        emb = self.encoder(feats, True)
        mesh = active_mesh()
        if mesh is not None and mesh.num_model > 1:
            emb = sum_gradients(emb, mesh.model_group)
        return self.projection.cross_entropy(emb, labels, scale, margin)
