"""Import reference TensorFlow-1.x checkpoints: the JAX package's
``utils/tf_import.py`` in the port, with its own bundle reader.

The reference trainer (ref tf_train_tdnn.py:304-311) checkpoints TF1 graphs
whose variables carry auto-uniquified default scope names (``conv2d_17``,
``batch_normalization_9``, split-stage BNs nested as
``conv2d_N/batch_normalization_M``). Both frameworks build the network in
the same order, so the flat TF numbering is *simulated* from the
architecture config and zipped with the flax-shaped module paths the JAX
package uses. Conv kernels are HWIO there and in TF, dense kernels (in, out)
and sub-center projection kernels (K, emb, classes): nothing is transposed
here. ``import_reference_weights`` returns flax-shaped ``(params,
batch_stats)`` nested dicts, which ``convert.from_flax`` (or
``convert.train_state_from_flax``) carries into the port's state_dict.

``load_tf_checkpoint`` reads the checkpoint with ``utils/tf_bundle.py``
(numpy and the standard library; no TensorFlow).

BN running statistics: the reference trains with per-replica BN and
checkpoints rank 0's moving statistics; inference uses whatever the
checkpoint carries, so an imported checkpoint reproduces the reference's
embeddings.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from ..models import DPN_CONFIGS, RES2NET_CONFIGS, TDNN_VARIANTS

Path = Tuple[str, ...]
VarMap = Dict[str, Tuple[str, Path]]  # tf name -> (collection, flax path)


def _tf_name(base: str, idx: int) -> str:
    return base if idx == 0 else f"{base}_{idx}"


class _NameSim:
    """Simulates TF1 default-name uniquification counters (graph-global)."""

    def __init__(self) -> None:
        self._conv = itertools.count()
        self._bn = itertools.count()

    def conv(self) -> str:
        return _tf_name("conv2d", next(self._conv))

    def bn(self) -> str:
        return _tf_name("batch_normalization", next(self._bn))


def _add_conv(m: VarMap, sim: _NameSim, path: Path) -> None:
    """ConvFixedPadding/Conv2d module: <path>/conv2d/conv/kernel."""
    m[f"{sim.conv()}/kernel"] = ("params", path + ("conv2d", "conv", "kernel"))


def _add_bn(m: VarMap, sim: _NameSim, path: Path) -> None:
    name = sim.bn()
    m[f"{name}/moving_mean"] = ("batch_stats", path + ("bn", "mean"))
    m[f"{name}/moving_variance"] = ("batch_stats", path + ("bn", "var"))


def _add_head(m: VarMap, sim: _NameSim, pool: str) -> None:
    """(att_)stats pool + flatten + BN + dense + BN (ref res2net_model.py:229-242,
    tdnn_model.py:142-153; att convs created inside the pool scope first,
    models.py:295-298)."""
    if pool == "att_stats":
        # The att convs live inside the 'att_stats_pool' variable scope, so
        # their conv2d numbering is scope-local (models.py:273,295-298).
        m["att_stats_pool/conv2d/kernel"] = (
            "params", ("head", "att_stats_pool", "att_conv1", "conv", "kernel"))
        m["att_stats_pool/conv2d_1/kernel"] = (
            "params", ("head", "att_stats_pool", "att_conv2", "conv", "kernel"))
    _add_bn(m, sim, ("head", "pre_bn"))
    m["dense/kernel"] = ("params", ("head", "embedding", "dense", "kernel"))
    _add_bn(m, sim, ("head", "post_bn"))


def res2net_var_map(model_name: str) -> VarMap:
    """Variable map for the Res2Net family (ref res2net_model.py:81-242)."""
    cfg = RES2NET_CONFIGS[model_name]
    m: VarMap = {}
    sim = _NameSim()
    _add_conv(m, sim, ("initial_conv",))
    _add_bn(m, sim, ("initial_bn",))
    for i, num_blocks in enumerate(cfg.block_sizes):
        for j in range(num_blocks):
            blk = f"layer{i + 1}_block{j + 1}"
            if j == 0:  # projection shortcut (ref res2net_model.py:85-87)
                _add_conv(m, sim, (blk, "proj_conv"))
                _add_bn(m, sim, (blk, "proj_bn"))
            _add_conv(m, sim, (blk, "conv1"))
            _add_bn(m, sim, (blk, "bn1"))
            # Split stage: one conv2d scope holding the shared kernel and
            # s-1 locally-numbered BNs (ref res2net_model.py:30-72).
            sc = sim.conv()
            m[f"{sc}/kernel"] = ("params", (blk, "split_conv", "kernel"))
            for k in range(cfg.split - 1):
                bn = _tf_name("batch_normalization", k)
                stat = (blk, "split_conv", f"bn{k}", "bn")
                m[f"{sc}/{bn}/moving_mean"] = ("batch_stats", stat + ("mean",))
                m[f"{sc}/{bn}/moving_variance"] = ("batch_stats", stat + ("var",))
            _add_conv(m, sim, (blk, "conv3"))
            _add_bn(m, sim, (blk, "bn3"))
    _add_head(m, sim, cfg.pool)
    return m


def tdnn_var_map(block_order: str = "conv_relu_bn", num_blocks: int = 5) -> VarMap:
    """Variable map for the TDNN recipe model (ref tdnn_model.py:24-31,142-153)."""
    if block_order != "conv_relu_bn":
        raise ValueError(f"only the recipe block type is mapped, not {block_order!r}")
    m: VarMap = {}
    sim = _NameSim()
    for i in range(num_blocks):
        # TdnnBlock holds Conv2d "conv2d" and BatchNorm "bn" (models/tdnn.py)
        m[f"{sim.conv()}/kernel"] = (
            "params", (f"block{i + 1}", "conv2d", "conv", "kernel"))
        _add_bn(m, sim, (f"block{i + 1}", "bn"))
    _add_head(m, sim, "stats")
    return m


def dpn_var_map(model_name: str) -> VarMap:
    """Variable map for the DPN family (ref dpn_model.py:32-171).

    Creation order: stem conv->BN (conv_bn_relu, :32-37); per block the
    projection bn_relu_conv first when present (:77), then conv_a/conv_b/
    conv_c (each BN before conv, :40-55); final concat BN (:152); head."""
    cfg = DPN_CONFIGS[model_name]
    m: VarMap = {}
    sim = _NameSim()
    m[f"{sim.conv()}/kernel"] = ("params", ("initial_conv", "conv", "kernel"))
    _add_bn(m, sim, ("initial_bn",))

    def brc(blk: str, mod: str) -> None:  # BnReluConv: BN then conv
        _add_bn(m, sim, (blk, mod, "bn"))
        m[f"{sim.conv()}/kernel"] = (
            "params", (blk, mod, "conv2d", "conv", "kernel"))

    for i in range(4):
        for j in range(cfg.k_sec[i]):
            blk = f"stage{i + 1}_block{j + 1}"
            if j == 0 and cfg.projection_types[i] != "normal":
                brc(blk, "proj")
            brc(blk, "conv_a")
            brc(blk, "conv_b")
            if cfg.use_se:
                raise ValueError("se DPN variants are not mapped")
            brc(blk, "conv_c")
    _add_bn(m, sim, ("final_bn",))
    _add_head(m, sim, cfg.pool)
    return m


def reference_var_map(model_name: str) -> VarMap:
    if model_name == "tdnn":
        return tdnn_var_map()
    if model_name in TDNN_VARIANTS:
        # variant widths come from the arrays; the map depends only on the
        # block count and ordering (TF1 numbering is positional)
        v = TDNN_VARIANTS[model_name]
        return tdnn_var_map(
            block_order=v.get("block_order", "conv_relu_bn"),
            num_blocks=len(v.get("block_filters", (0,) * 5)))
    if model_name in RES2NET_CONFIGS:
        return res2net_var_map(model_name)
    if model_name in DPN_CONFIGS:
        return dpn_var_map(model_name)
    raise ValueError(f"unknown model {model_name!r}")


def import_reference_weights(
    values: Mapping[str, np.ndarray],
    model_name: str,
    projection_id: Optional[str] = None,
    params_only: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert {tf_var_name: array} into (params, batch_stats) nested dicts.

    ``values`` keys may carry the ``:0`` tensor suffix and/or trailing
    optimizer slots (``/Momentum``); both are ignored.  If ``projection_id``
    is given, ``<projection_id>/kernel`` (ref tf_projection.py, e.g.
    ``sc_cm_linear/kernel``) is imported as ``params/projection/kernel`` and
    the encoder lands under ``params/encoder`` (the SpeakerNet layout).
    """
    clean: Dict[str, np.ndarray] = {}
    for k, v in values.items():
        k = k[:-2] if k.endswith(":0") else k
        if k.endswith("/Momentum") or k in ("global_step",):
            continue
        clean[k] = np.asarray(v)

    var_map = reference_var_map(model_name)
    if params_only:
        # e.g. optimizer slot snapshots: only trainables have slots.
        var_map = {k: v for k, v in var_map.items() if v[0] == "params"}
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    def assign(tree: Dict[str, Any], path: Path, arr: np.ndarray) -> None:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr

    missing = [name for name in var_map if name not in clean]
    if missing:
        raise KeyError(f"checkpoint is missing {len(missing)} variables, "
                       f"e.g. {missing[:5]}")
    for tf_name, (col, path) in var_map.items():
        if projection_id is not None:
            path = ("encoder",) + path
        assign(params if col == "params" else batch_stats, path, clean[tf_name])

    if projection_id is not None:
        key = f"{projection_id}/kernel"
        if key not in clean:
            raise KeyError(f"projection kernel {key!r} not in checkpoint")
        assign(params, ("projection", "kernel"), clean[key])
    return params, batch_stats


def load_tf_checkpoint(path: str, verbose: bool = False) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint (``<prefix>`` of ``<prefix>.index``
    and its data shards), through the port's bundle reader; ``verbose``
    prints the bytes read and the reader's rate on this host."""
    from .tf_bundle import BundleReader

    t0 = time.perf_counter()
    reader = BundleReader(path)
    values = reader.read_all()
    if verbose:
        dt = time.perf_counter() - t0
        print(f"read {len(values)} variables, {reader.bytes_read / 1e6:.1f} MB in {dt:.3f} s "
              f"({reader.bytes_read / 1e6 / max(dt, 1e-9):.1f} MB/s, host)")
    return values
