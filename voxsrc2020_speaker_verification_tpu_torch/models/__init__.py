"""Speaker-embedding models of the port: the Res2Net family.

``get_model(name)`` resolves the same model ids as the JAX package. TDNN, DPN
and ECAPA are not ported yet (ROADMAP.md lists them) and raise.
"""

from __future__ import annotations

from .res2net import (Res2Net, Res2NetConfig, RES2NET_CONFIGS,
                      register_res2net_variant)


def get_model(name: str, dtype=None, *, feat_dim: int = 80, remat: bool = False,
              remat_policy=None, remat_stages=None, remat_keep_blocks=None):
    """Build a model by recipe id; ``dtype`` is the compute dtype.

    Rematerialization is not ported: ``torch.utils.checkpoint`` recomputes
    the forward, which would apply the training BN's running-statistics
    update twice (ROADMAP.md)."""
    if remat or remat_policy or remat_stages or remat_keep_blocks:
        raise NotImplementedError(
            "remat / remat_stages / remat_keep_blocks are not ported yet "
            "(ROADMAP.md): a recomputed forward would update the BN running "
            "statistics twice")
    if name in RES2NET_CONFIGS:
        return Res2Net(RES2NET_CONFIGS[name], feat_dim=feat_dim, dtype=dtype)
    raise NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet (see ROADMAP.md); "
        f"ported: {tuple(RES2NET_CONFIGS)}")
