"""Training across processes on ``torch.distributed``: the (data, model)
layout of the ranks and its collectives (``sharding.py``)."""

from .sharding import (  # noqa: F401
    MESH_DATA, MESH_MODEL, Mesh, active, active_mesh, batch_spec, class_range, make_mesh,
    param_shardings,
)
