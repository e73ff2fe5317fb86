"""The training step: one optimizer step over A microbatches.

The semantics of the JAX package's ``training/trainer.py``:

* the A microbatches run in sequence; each one's BN running statistics
  update in place (K5) before the next, as the JAX scan carries them;
* cross-entropy is the mean within each microbatch; its gradients add up in
  float32 (``.grad`` of the float32 parameters) and are scaled by 1/A;
* the closed-form l2 gradient ``l2_scale * p`` is added to every parameter,
  the projection kernel included, before the global-norm clip
  ``min(1, clip / (gnorm + 1e-12))``;
* trace-form SGD momentum, ``m = 0.9 m + g; p -= lr * m``;
* learning rate and margin come from the schedules at the step before the
  increment;
* in raw-audio mode (``config.raw_audio``) each microbatch's waveform crops
  become features on the device first (``ops/pipeline.py``: K1, dithered
  when ``config.dither`` is nonzero, then K7 and the crop gather), outside
  autograd, as no gradient flows into the JAX package's features either.
  The dither draws come from a generator seeded by (config.seed, global
  step, microbatch), so a resumed run draws the same noise; they are not
  the JAX package's threefry draws, only of the same distribution;
* with ``config.specaug`` each microbatch's features get one time and one
  frequency mask per utterance (``ops/specaug.py``) before the forward,
  drawn from a generator of their own seeded the same way;
* across processes (a state with a ``parallel.Mesh`` of more than one
  rank): each data rank steps on its block of the global microbatch (the
  JAX step under ``make_mesh``). Training BN keeps ``bn_groups``' meaning
  (``ops/nn.py:bn_train``), the head's classes are split over the model
  ranks (K6's class-sharded mode), the embedding's gradient is summed over
  the model group, every gradient is averaged over the data ranks that hold
  its parameter (one all-reduce), the l2 term, the regularization loss and
  the global norm count the head's shards once each and the trunk once,
  the logged metrics are the global batch's on every rank, and BN running
  statistics of groups inside a rank are averaged over the data ranks once
  a step (their update is linear in the group means). Dither and
  SpecAugment are drawn for the global microbatch and each rank keeps its
  rows, so the draws do not depend on the world size.

The update runs in place with ``torch._foreach_*`` (the JAX package builds
new arrays). Parameters stay float32; the model casts each weight to the
compute dtype where it uses it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..config import TrainConfig
from ..convert import init_weights
from ..losses import schedules
from ..ops.fbank import FbankConfig, draw_noise
from ..ops import specaug
from ..ops.pipeline import waveform_to_features
from ..parallel import sharding
from .speaker_net import SpeakerNet


@dataclasses.dataclass
class TrainState:
    step: int                          # global optimizer step
    net: SpeakerNet                    # params (float32) and BN batch_stats
    momentum: Dict[str, torch.Tensor]  # SGD momentum trace per parameter, float32
    mesh: sharding.Mesh = dataclasses.field(default_factory=sharding.Mesh)

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.net.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_buffers())


def build_speaker_net(config: TrainConfig,
                      device: Optional[Union[str, torch.device]] = None,
                      class_range: Optional[Tuple[int, int]] = None) -> SpeakerNet:
    """The config's training net on ``device`` (default ``cuda``), bfloat16
    compute when ``config.bf16``, with the config's rematerialization
    options; ``class_range`` makes its head one class shard."""
    dev = resolve_device(device)
    net = SpeakerNet(config.model, config.projection, config.num_classes,
                     config.num_centers, config.feat_dim,
                     torch.bfloat16 if config.bf16 else None, config.bn_groups,
                     class_range=class_range,
                     remat=config.remat, remat_policy=config.remat_policy,
                     remat_stages=config.remat_stages,
                     remat_keep_blocks=config.remat_keep_blocks)
    return net.to(dev)


def create_train_state(config: TrainConfig,
                       device: Optional[Union[str, torch.device]] = None,
                       seed: Optional[int] = None,
                       mesh: Optional[sharding.Mesh] = None) -> TrainState:
    """Step 0: seeded weights (``convert.init_weights`` with the projection),
    BN statistics at mean 0 / var 1 as the JAX package initializes them, and
    a zero momentum trace. With a ``mesh`` of model ranks every rank draws
    the whole head from the seed and keeps its classes
    (``parallel.param_shardings``)."""
    mesh = mesh or sharding.Mesh()
    shard = None
    if mesh.num_model > 1:
        shard = sharding.class_range(config.num_classes, mesh.num_model, mesh.model_rank)
    net = build_speaker_net(config, device, class_range=shard)
    gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
    state = init_weights(config, gen, projection=True)
    for name in state:
        if name.endswith(".running_mean"):
            state[name] = torch.zeros_like(state[name])
        elif name.endswith(".running_var"):
            state[name] = torch.ones_like(state[name])
    net.load_state_dict(shard_state(state, mesh))
    momentum = {k: torch.zeros_like(p) for k, p in net.named_parameters()}
    return TrainState(step=0, net=net, momentum=momentum, mesh=mesh)


def shard_state(full: Dict[str, torch.Tensor], mesh: sharding.Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole model's tensors (``param_shardings``)."""
    specs = sharding.param_shardings(mesh, {k: v.shape for k, v in full.items()})
    out = {}
    for name, t in full.items():
        spec = specs[name]
        out[name] = t if spec is None else t.narrow(spec[0], spec[1], spec[2] - spec[1])
    return out


def schedule_values(config: TrainConfig, step: int) -> Tuple[float, float]:
    """(learning rate, margin) at a global step, float32 values."""
    epoch = config.epoch_size
    lr_bounds = [epoch * b for b in config.lr_boundaries_epochs]
    margin_bounds = [epoch * b for b in config.margin_boundaries_epochs]
    if config.lr_schedule == "cosine":
        lr = schedules.warmup_constant_cosine_decay(config.learning_rate, step, lr_bounds)
    else:
        lr = schedules.warmup_constant_exponential_decay(
            config.learning_rate, step, lr_bounds, epoch, decay_rate=config.decay_rate)
    margin = schedules.zero_linear_constant(config.margin, step, margin_bounds, epoch)
    return float(lr), float(margin)


def _seeded_generator(entropy, device: torch.device) -> torch.Generator:
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def dither_generator(config: TrainConfig, step: int, microbatch: int,
                     device: torch.device) -> torch.Generator:
    """The generator of one microbatch's dither draws: seeded by
    (config.seed, global step, microbatch), so a resumed run draws what the
    uninterrupted run drew."""
    return _seeded_generator([config.seed, step, microbatch], device)


def specaug_generator(config: TrainConfig, step: int, microbatch: int,
                      device: torch.device) -> torch.Generator:
    """The generator of one microbatch's SpecAugment draws: seeded by
    (config.seed, global step, microbatch), a stream apart from the
    dither's."""
    return _seeded_generator([config.seed, step, microbatch, 1], device)


def _global_rows(mesh: sharding.Mesh, local: int):
    """(global microbatch rows, this rank's slice of them)."""
    start = mesh.data_rank * local
    return local * mesh.num_data, slice(start, start + local)


def make_train_step(config: TrainConfig):
    """Returns step(state, features, labels) -> (state, metrics).

    features: (A, B, T, F) float32 or bfloat16, or in raw-audio mode the
    tuple (waves (A, B, S) int16 or float32, num_samples, target_offset,
    pad_shift each (A, B)); labels: (A, B) integers; all on the state's
    device; B is this rank's block of the global microbatch under a mesh.
    The state is updated in place and returned with its step incremented;
    the metrics are 0-d float32 tensors, on the device except the host-side
    schedule values (no host sync)."""
    if config.raw_audio:
        fbank_cfg = FbankConfig(num_bins=config.feat_dim, dither=config.dither)

    def microbatch_features(features, a: int, step: int, mesh) -> torch.Tensor:
        if not config.raw_audio:
            feats = features[a].float()
        else:
            waves, num_samples, offset, shift = (x[a] for x in features)
            noise = None
            if config.dither:
                rows, mine = _global_rows(mesh, waves.shape[0])
                noise = draw_noise(rows, waves.shape[1], fbank_cfg,
                                   dither_generator(config, step, a, waves.device),
                                   waves.device)[mine]
            with torch.no_grad():
                feats = waveform_to_features(waves, num_samples, offset, shift, fbank_cfg,
                                             config.feat_length, window=config.cmn_window,
                                             context=config.cmn_context, noise=noise)
        if config.specaug:
            b, t, f = feats.shape
            rows, mine = _global_rows(mesh, b)
            draws = specaug.draw(rows, t, f, specaug_generator(config, step, a, feats.device),
                                 feats.device)
            feats = specaug.spec_augment(feats, specaug.Draws(*(d[mine] for d in draws)))
        return feats

    def step_fn(state: TrainState, features,
                labels: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        fields = features if isinstance(features, tuple) else (features,)
        want = [3, 2, 2, 2] if config.raw_audio else [4]  # (A, B, S) and (A, B) / (A, B, T, F)
        if [x.ndim for x in fields] != want or labels.ndim != 2:
            raise ValueError(f"features of {want} dims and labels (A, B), got "
                             f"{[tuple(x.shape) for x in fields]}, {tuple(labels.shape)}")
        lr, margin = schedule_values(config, state.step)
        net, mesh = state.net, state.mesh
        names = [k for k, _ in net.named_parameters()]
        params = [p for _, p in net.named_parameters()]
        for p in params:
            p.grad = None
        num_accum = labels.shape[0]
        ces, accs = [], []
        with sharding.active(mesh):
            for a in range(num_accum):
                loss_rows, correct = net.loss(
                    microbatch_features(features, a, state.step, mesh), labels[a],
                    config.scale, margin)
                ce = loss_rows.mean()
                ce.backward()
                ces.append(ce.detach())
                accs.append(correct.detach().mean())

        with torch.no_grad():
            grads = [p.grad for p in params]
            data = [p.detach() for p in params]
            # mean over microbatches and data ranks, plus the closed-form l2 gradient
            sharding.flat_all_reduce_(grads, mesh.data_group, 1.0 / (num_accum * mesh.num_data))
            torch._foreach_add_(grads, torch._foreach_mul(data, config.l2_scale))
            if mesh.num_model == 1:
                reg_loss = config.l2_scale * 0.5 * torch.stack(
                    [torch.sum(torch.square(p)) for p in data]).sum()
                gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            else:
                # the head's shards once each (summed over the model group), the trunk once
                sq = torch.stack([torch.stack([torch.sum(torch.square(p)) for p in data]),
                                  torch.stack(torch._foreach_norm(grads)) ** 2])
                head = torch.tensor([sharding.is_projection_kernel(k) for k in names],
                                    device=sq.device)
                totals = sq[:, ~head].sum(1) + sharding.all_reduce_(sq[:, head].sum(1),
                                                                    mesh.model_group)
                reg_loss = config.l2_scale * 0.5 * totals[0]
                gnorm = torch.sqrt(totals[1])
            clip = torch.clamp(config.clip_norm / (gnorm + 1e-12), max=1.0)
            torch._foreach_mul_(grads, clip)
            mom = [state.momentum[k] for k in names]
            torch._foreach_mul_(mom, config.momentum)
            torch._foreach_add_(mom, grads)
            torch._foreach_add_(data, torch._foreach_mul(mom, lr), alpha=-1.0)
            for p in params:
                p.grad = None
            means = torch.stack([torch.stack(ces).mean(), torch.stack(accs).mean()])
            if mesh.num_data > 1:
                sharding.all_reduce_(means, mesh.data_group).div_(mesh.num_data)
                if config.bn_groups % mesh.num_data == 0:  # groups inside each rank
                    sharding.flat_all_reduce_([b for _, b in net.named_buffers()],
                                              mesh.data_group, 1.0 / mesh.num_data)

        ce_mean = means[0]
        metrics = {
            "classification_loss": ce_mean,
            "regularization_loss": reg_loss,
            "loss": ce_mean + reg_loss,
            "accuracy": means[1],
            # host values: the schedules run on the host
            "learning_rate": torch.tensor(lr, dtype=torch.float32),
            "margin": torch.tensor(float(schedules.total_margin(config.projection, margin)),
                                   dtype=torch.float32),
            "gradient_norm": gnorm,
        }
        state.step += 1
        return state, metrics

    return step_fn
