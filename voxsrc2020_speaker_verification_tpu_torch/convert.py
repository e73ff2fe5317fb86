"""Weights carried across: flax variables -> the port's state_dict, and a
seeded initializer for machines without JAX.

Flax paths map to module paths with the wrapper levels dropped:

    params/encoder/layer1_block1/conv1/conv2d/conv/kernel (HWIO)
        -> encoder.layer1_block1.conv1.conv2d.weight       (OIHW)
    params/encoder/layer1_block1/split_conv/kernel [3, 3, w, w*(s-1)]
        -> encoder.layer1_block1.split_conv.weight [w*(s-1), w, 3, 3]
    params/encoder/head/embedding/dense/kernel (in, out)
        -> encoder.head.embedding.weight           (out, in)
    batch_stats/encoder/layer1_block1/bn1/bn/{mean,var}
        -> encoder.layer1_block1.bn1.running_{mean,var}

H is time and W is frequency on both sides; the dense rows stay in the NHWC
flatten order, which the port's head keeps. The margin projection kernel
(K, emb, C) is not part of the served encoder: it goes to
``projection_weight.pkl`` (eval/export.py:export_projection_weights).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .config import TrainConfig
from .speaker_net import SpeakerNet

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` nested dicts of arrays (e.g.
    ``jax.device_get(state.params)``) -> SpeakerNet state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables.get("params", {})):
        if path[0] == "projection":
            continue
        if path[-1] != "kernel":
            raise ValueError(f"unexpected param {'/'.join(path)}")
        a = np.asarray(value, np.float32)
        mod = path[:-1]
        if mod and mod[-1] in ("conv", "dense"):
            mod = mod[:-1]
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        out[".".join(mod + ("weight",))] = torch.from_numpy(np.ascontiguousarray(a))
    for path, value in _leaves(variables.get("batch_stats", {})):
        if path[-2:-1] != ("bn",) or path[-1] not in ("mean", "var"):
            raise ValueError(f"unexpected batch stat {'/'.join(path)}")
        name = ".".join(path[:-2] + ("running_" + path[-1],))
        out[name] = torch.from_numpy(np.array(value, np.float32))
    return out


def init_weights(config: TrainConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A seeded float32 state_dict for ``config.model``: truncated-normal
    fan-in kernels (the JAX package's variance_scaling(1, fan_in,
    truncated_normal)) and non-trivial BN statistics, mean ~ N(0, 0.1) and
    var ~ U(0.5, 2), so a wrong normalization cannot hide behind identity
    statistics."""
    net = SpeakerNet(config.model, config.feat_dim)
    state = {}
    for name, t in net.state_dict().items():
        if name.endswith(".weight"):
            fan_in = math.prod(t.shape[1:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            v = torch.nn.init.trunc_normal_(torch.empty_like(t), 0.0, std,
                                            -2 * std, 2 * std, generator=generator)
        elif name.endswith(".running_mean"):
            v = 0.1 * torch.randn(t.shape, generator=generator)
        elif name.endswith(".running_var"):
            v = 0.5 + 1.5 * torch.rand(t.shape, generator=generator)
        else:
            raise ValueError(f"unexpected state entry {name}")
        state[name] = v
    return state
