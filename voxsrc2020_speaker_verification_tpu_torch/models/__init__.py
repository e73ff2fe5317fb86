"""Speaker-embedding models of the port: TDNN, the Res2Net family (stats and
attentive-stats pooling), DPN and ECAPA-TDNN.

``get_model(name)`` resolves the same model ids as the JAX package.
"""

from __future__ import annotations

from .dpn import DPN_CONFIGS, Dpn, DpnConfig
from .ecapa import ECAPA_CONFIGS, Ecapa, EcapaConfig
from .res2net import (Res2Net, Res2NetConfig, RES2NET_CONFIGS,
                      register_res2net_variant)
from .tdnn import TDNN_VARIANTS, Tdnn, TdnnConfig, register_tdnn_variant, tdnn_config

MODEL_NAMES = (("tdnn",) + tuple(RES2NET_CONFIGS) + tuple(DPN_CONFIGS)
               + tuple(ECAPA_CONFIGS))


def get_model(name: str, dtype=None, *, feat_dim: int = 80, remat: bool = False,
              remat_policy=None, remat_stages=None, remat_keep_blocks=None):
    """Build a model by recipe id; ``dtype`` is the compute dtype and
    ``feat_dim`` the input's feature width. ``remat*`` are the JAX package's
    rematerialization options, taken by the Res2Net and DPN families (as the
    JAX package's ``get_model`` passes them); an unknown ``remat_policy``
    raises ValueError."""
    remat_kw = dict(remat=remat, remat_policy=remat_policy, remat_stages=remat_stages,
                    remat_keep_blocks=remat_keep_blocks)
    if name == "tdnn" or name in TDNN_VARIANTS:
        return Tdnn(tdnn_config(name), feat_dim=feat_dim, dtype=dtype)
    if name in RES2NET_CONFIGS:
        return Res2Net(RES2NET_CONFIGS[name], feat_dim=feat_dim, dtype=dtype, **remat_kw)
    if name in DPN_CONFIGS:
        return Dpn(DPN_CONFIGS[name], feat_dim=feat_dim, dtype=dtype, **remat_kw)
    if name in ECAPA_CONFIGS:
        return Ecapa(ECAPA_CONFIGS[name], feat_dim=feat_dim, dtype=dtype)
    raise ValueError(f"unknown model {name!r}; available: {MODEL_NAMES}")
