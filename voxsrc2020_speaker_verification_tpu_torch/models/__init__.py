"""Speaker-embedding models of the port: the Res2Net family.

``get_model(name)`` resolves the same model ids as the JAX package. TDNN, DPN
and ECAPA are not ported yet (ROADMAP.md lists them) and raise.
"""

from __future__ import annotations

from .res2net import (Res2Net, Res2NetConfig, RES2NET_CONFIGS,
                      register_res2net_variant)


def get_model(name: str, dtype=None, *, feat_dim: int = 80):
    """Build a model by recipe id; ``dtype`` is the compute dtype."""
    if name in RES2NET_CONFIGS:
        return Res2Net(RES2NET_CONFIGS[name], feat_dim=feat_dim, dtype=dtype)
    raise NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet (see ROADMAP.md); "
        f"ported: {tuple(RES2NET_CONFIGS)}")
