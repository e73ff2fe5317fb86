"""The (data, model) layout of training processes on ``torch.distributed``.

The JAX package's ``parallel/sharding.py`` lays its devices out as a
``(data, model)`` mesh and lets GSPMD place the collectives. Here each
process is one rank of such a layout, and the collectives are explicit:

* axis ``data``  -- the per-microbatch batch is split over the data ranks in
  contiguous blocks (:func:`batch_spec`); trunk gradients are averaged over
  them, and training BN keeps ``bn_groups``' meaning across them
  (``ops/nn.py:bn_train``: groups inside one rank run as before, groups
  that span ranks all-reduce their sums).
* axis ``model`` -- the margin head's kernel (K, emb, classes) is split on
  its class axis in contiguous ranges, which may be uneven
  (:func:`param_shardings`); the ranks of one model group see the same rows
  and all-reduce each row's log-sum-exp (``losses/projections.py``), and
  sum the embedding's gradient.

Rank ``r`` is data rank ``r // num_model`` and model rank ``r % num_model``
(the JAX mesh's ``reshape(num_data, num_model)``). Everything else (the
trunk, the BN statistics, the momentum of replicated parameters) is
replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

MESH_DATA = "data"
MESH_MODEL = "model"


@dataclasses.dataclass
class Mesh:
    """One process's place in a (data, model) layout of ``num_data *
    num_model`` ranks, with the process groups of its collectives
    (``None`` for an axis of size 1): ``data_group`` holds the ranks of its
    model rank (over which the batch is split), ``model_group`` the ranks of
    its data rank (which share rows and split the classes)."""
    num_data: int = 1
    num_model: int = 1
    rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.num_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.num_model

    @property
    def model_root(self) -> int:
        """Global rank of the first rank of this process's model group."""
        return self.data_rank * self.num_model


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """This process's mesh over the initialized ``torch.distributed`` world
    (one process: a mesh of one rank and no groups). Every rank must call it,
    in the same order as the other ranks: it creates every data and model
    group of the world."""
    if not (dist.is_available() and dist.is_initialized()):
        if (num_data or 1) * num_model != 1:
            raise ValueError(f"a ({num_data}, {num_model}) mesh needs torch.distributed "
                             f"initialized with that many ranks")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh ({num_data} data x {num_model} model) != world size {world}")
    mesh = Mesh(num_data, num_model, rank)
    for m in range(num_model):  # data groups: the ranks of model rank m
        ranks = [d * num_model + m for d in range(num_data)]
        group = dist.new_group(ranks) if num_data > 1 else None
        if m == mesh.model_rank:
            mesh.data_group = group
    for d in range(num_data):  # model groups: the ranks of data rank d
        ranks = [d * num_model + m for m in range(num_model)]
        group = dist.new_group(ranks) if num_model > 1 else None
        if d == mesh.data_rank:
            mesh.model_group = group
    return mesh


def class_range(num_classes: int, num_model: int, model_rank: int) -> Tuple[int, int]:
    """Classes [start, stop) of one model rank: contiguous, the first
    ``num_classes % num_model`` ranges one class longer."""
    base, extra = divmod(num_classes, num_model)
    start = model_rank * base + min(model_rank, extra)
    return start, start + base + (1 if model_rank < extra else 0)


def is_projection_kernel(name: str) -> bool:
    return name.split(".")[0] == "projection" and name.endswith("kernel")


def param_shardings(mesh: Mesh, shapes: Mapping[str, torch.Size]
                    ) -> Dict[str, Optional[Tuple[int, int, int]]]:
    """For each named parameter (or its momentum) of the whole model: ``None``
    (replicated) or ``(dim, start, stop)``, the slice of its full shape this
    rank holds. The projection kernel shards its class (last) axis over
    ``model``; all else is replicated."""
    out: Dict[str, Optional[Tuple[int, int, int]]] = {}
    for name, shape in shapes.items():
        if is_projection_kernel(name) and mesh.num_model > 1:
            out[name] = (len(shape) - 1, *class_range(shape[-1], mesh.num_model,
                                                      mesh.model_rank))
        else:
            out[name] = None
    return out


def batch_spec(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """Rows [start, stop) of the global per-microbatch batch this rank
    holds: a contiguous block per data rank, the same for every rank of a
    model group."""
    if batch_size % mesh.num_data:
        raise ValueError(f"batch {batch_size} does not split over {mesh.num_data} data ranks")
    local = batch_size // mesh.num_data
    return mesh.data_rank * local, (mesh.data_rank + 1) * local


# ---------------------------------------------------------------------------
# the mesh of the running step, and the collectives its modules take
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the block with ``mesh`` as the layout of training BN and the
    margin head. A global, not per thread: autograd's backward threads and
    a rematerialized block's recompute see it too."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = mesh
    try:
        yield
    finally:
        _ACTIVE = before


def active_mesh() -> Optional[Mesh]:
    """The mesh of the running step where it has more than one rank, else None."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.size > 1 else None


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` (no-op for ``None``); raises
    if the collective fails."""
    if group is not None:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group on every rank; dx = the sum of dy."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (the plain versions' collective)."""
    return x if group is None else _AllReduceSum.apply(x, group)


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    embedding before a class-sharded head: each rank's head gives the
    gradient of its classes only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(memory_format=torch.contiguous_format), ctx.group), None


def sum_gradients(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumGradients.apply(x, group)


class _GatherClasses(torch.autograd.Function):
    """(B, C_shard) columns [start, stop) of each rank -> (B, C) on every
    rank of the group, by one all-reduce of a zeroed buffer (gloo moves CUDA
    tensors by all-reduce and broadcast only). Every rank computes the same
    loss from the whole tensor, so a rank's gradient is its own columns of
    the whole gradient."""

    @staticmethod
    def forward(ctx, x, class_range, num_classes, group):
        ctx.class_range = class_range
        buf = x.new_zeros((x.shape[0], num_classes))
        buf[:, class_range[0]:class_range[1]] = x
        return all_reduce_(buf, group)

    @staticmethod
    def backward(ctx, dy):
        start, stop = ctx.class_range
        return dy[:, start:stop], None, None, None


def gather_classes(x: torch.Tensor, class_range: Tuple[int, int], num_classes: int,
                   group) -> torch.Tensor:
    """The whole head's (B, C) from each model rank's class columns,
    differentiable in this rank's."""
    return _GatherClasses.apply(x, tuple(class_range), num_classes, group)


def flat_all_reduce_(tensors: List[torch.Tensor], group, scale: float = 1.0) -> None:
    """Sum a list of tensors over ``group`` in one collective (one flat
    buffer), times ``scale``, in place."""
    if group is None or not tensors:
        if scale != 1.0:
            torch._foreach_mul_(tensors, scale)
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
