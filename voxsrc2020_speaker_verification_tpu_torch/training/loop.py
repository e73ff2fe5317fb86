"""Training loop: feeder -> device prefetch -> train step -> logging and
per-epoch checkpoints, in one process or as one rank of many.

The JAX package's ``training/loop.py:fit``: the same log line
every ``log_every`` optimizer steps (loss, ce, reg, accuracy, lr, margin,
gnorm, audio-s/s, and the feeder's decode errors when there are any),
``metrics.jsonl`` and checkpoints in the experiment dir, the LMFT resume
through ``resume_from``, the feeder health checks (a shard that decodes
nothing over a full pass raises IOError) and SIGTERM preemption (a final
checkpoint and ``FitResult.preempted``).

Across processes (``mesh``, ``parallel.make_mesh``) each rank feeds its
block of the global batch; the ranks of one model group train on the same
rows, which the group's first rank broadcasts (a feeder's order depends on
its threads' timing); every rank logs the same, global, metrics line;
process 0 alone writes ``config.json``, ``metrics.jsonl`` and the
checkpoints (whose head every rank helps gather).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import signal
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..config import TrainConfig
from ..parallel import sharding
from .checkpoint import restore_or_init
from .trainer import TrainState, create_train_state, make_train_step


@dataclasses.dataclass
class FitResult:
    state: TrainState
    steps_run: int
    audio_seconds_per_second: float
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    preempted: bool = False


class _PrefetchError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def device_prefetch(iterator: Iterable, device: torch.device, depth: int = 2):
    """Double-buffered device feed of (features, labels) batches, where
    features is an array or, in raw-audio mode, a tuple of arrays (int16
    waves and three int32 fields), each moved in its own dtype.

    On CUDA a background thread pins each batch and copies it on a side
    stream, up to ``depth`` batches ahead, so the copy overlaps the running
    step; the consumer's stream waits on the copy's event before the batch
    is yielded, and ``record_stream`` keeps the side stream's allocation
    alive for the consumer. On the CPU the batches pass through as tensors.
    """
    def as_tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))

    def fields(feats, labels):
        parts = feats if isinstance(feats, tuple) else (feats,)
        return [as_tensor(x) for x in parts] + [as_tensor(labels).long()]

    def rebuild(tensors, raw):
        feats = tuple(tensors[:-1]) if raw else tensors[0]
        return feats, tensors[-1]

    if device.type != "cuda":
        for feats, labels in iterator:
            yield rebuild(fields(feats, labels), isinstance(feats, tuple))
        return

    stream = torch.cuda.Stream(device)
    buf: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for feats, labels in iterator:
                if stop.is_set():
                    return
                host = [t.pin_memory() for t in fields(feats, labels)]
                with torch.cuda.stream(stream):
                    dev = [t.to(device, non_blocking=True) for t in host]
                    event = torch.cuda.Event()
                    event.record(stream)
                put((dev, isinstance(feats, tuple), event))
        except BaseException as e:  # surfaced in the consumer thread
            put(_PrefetchError(e))
            return
        put(done)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = buf.get()
            if item is done:
                return
            if isinstance(item, _PrefetchError):
                raise item.exc
            tensors, raw, event = item
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in tensors:
                t.record_stream(current)
            yield rebuild(tensors, raw)
    finally:
        stop.set()
        thread.join(timeout=5)


def fit(config: TrainConfig, batches: Iterable, exp_dir: Optional[str] = None,
        resume_from: Optional[str] = None, log_every: int = 100,
        log_fn: Callable[[str], None] = print, max_steps: Optional[int] = None,
        checkpoint: bool = True, save_every_steps: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
        state: Optional[TrainState] = None,
        handle_preemption: bool = True,
        mesh: Optional[sharding.Mesh] = None) -> FitResult:
    """Train until ``config.total_steps`` (or ``max_steps`` more steps).

    batches: iterable of (features (A, B, T, F), labels (A, B)) -- e.g. a
    started BatchFeeder or NativeBatchFeeder -- or, with
    ``config.raw_audio``, of ((waves (A, B, S) int16, num_samples,
    target_offset, pad_shift), labels) from a NativeRawBatchFeeder or a
    BatchFeeder over RawAudioShardDataset sources; audio-s/s counts the
    trained frames (effective batch x feat_length / 100) either way.
    ``device`` defaults to
    ``cuda``; ``state`` (default: ``create_train_state``) is trained in
    place. ``FitResult.history`` holds every logged step's metrics, with its
    audio-s/s and host time.

    A feeder with ``decode_errors()`` has them logged; one with
    ``dead_shards()`` is checked every ``log_every`` steps (100 when logging
    is off), and a dead shard raises IOError. With checkpointing on, on the
    main thread and ``handle_preemption``, SIGTERM ends the run after the
    current step with a checkpoint and ``FitResult.preempted``; the previous
    SIGTERM handler is restored on return.

    ``mesh`` (default: the state's, else one process) lays the ranks out;
    ``batches`` then yield this rank's block of each microbatch.
    """
    dev = resolve_device(device)
    exp_dir = exp_dir or config.exp_dir
    if state is None:
        state = create_train_state(config, dev, mesh=mesh)
    mesh = state.mesh
    chief = mesh.rank == 0

    mgr = metrics_writer = None
    if checkpoint:
        from ..utils.observability import MetricsWriter
        os.makedirs(exp_dir, exist_ok=True)
        if chief:
            config.to_json(os.path.join(exp_dir, "config.json"))
            metrics_writer = MetricsWriter(exp_dir)
        state, mgr = restore_or_init(state, exp_dir, resume_from=resume_from,
                                     max_to_keep=config.total_epochs + 1)
    elif resume_from is not None:
        # no saving, but a resume source: still restore -- training from a
        # fresh init would be a wrong run, not a fast one
        from .checkpoint import CheckpointManager
        CheckpointManager(resume_from).restore(state)

    step_fn = make_train_step(config)
    start_step = state.step
    stop_step = config.total_steps
    if max_steps is not None:
        stop_step = min(stop_step, start_step + max_steps)
    epoch_size = config.epoch_size
    audio_s_per_step = config.effective_batch * config.feat_length / 100.0

    preempt = threading.Event()
    trap_sigterm = (handle_preemption and mgr is not None
                    and threading.current_thread() is threading.main_thread())
    prev_handler = (signal.signal(signal.SIGTERM, lambda _sig, _frame: preempt.set())
                    if trap_sigterm else None)

    it = device_prefetch(iter(batches), dev, depth=2)
    history: List[Dict[str, float]] = []
    t_log = t_start = time.perf_counter()
    steps_run = 0
    cur = start_step
    try:
        while cur < stop_step and not preempt.is_set():
            feats, labels = next(it)
            if mesh.num_model > 1:  # the model group's rows are its first rank's
                for t in (*(feats if isinstance(feats, tuple) else (feats,)), labels):
                    torch.distributed.broadcast(t, src=mesh.model_root, group=mesh.model_group)
            state, metrics = step_fn(state, feats, labels)
            cur += 1
            steps_run += 1
            if log_every and (cur % log_every == 0 or cur == stop_step):
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                done = log_every if cur % log_every == 0 else cur % log_every
                rate = done / (now - t_log) * audio_s_per_step
                t_log = now
                errs = batches.decode_errors() if hasattr(batches, "decode_errors") else 0
                log_fn(
                    f"step {cur}/{stop_step} loss {m['loss']:.4f} "
                    f"(ce {m['classification_loss']:.4f} reg {m['regularization_loss']:.4f}) "
                    f"acc {m['accuracy']:.4f} lr {m['learning_rate']:.6f} "
                    f"margin {m['margin']:.4f} gnorm {m['gradient_norm']:.2f} "
                    f"audio-s/s {rate:.0f}" + (f" decode-errors {errs}" if errs else ""))
                history.append({"step": cur, **m, "audio_s_per_s": rate, "time": now})
                if metrics_writer is not None:
                    metrics_writer.write(cur, m, audio_s_per_s=rate,
                                         **({"decode_errors": errs} if errs else {}))
            # the dead-shard check on its own cadence: it must fire with
            # logging off too, or a corrupt shard would silently shrink the
            # training set
            if cur % (log_every or 100) == 0 and hasattr(batches, "dead_shards"):
                dead = batches.dead_shards()
                if dead:
                    errs = batches.decode_errors() if hasattr(batches, "decode_errors") else 0
                    raise IOError(
                        f"{dead} feeder shard(s) decoded nothing over a full pass ({errs} "
                        f"decode errors): part of the dataset is missing (corrupt ark or "
                        f"feat-dim mismatch); refusing to keep training")
            if mgr is not None and (cur % epoch_size == 0
                                    or (save_every_steps and cur % save_every_steps == 0)):
                mgr.save(state, step=cur)
    finally:
        it.close()
        # the previous SIGTERM disposition comes back even on an exception
        if trap_sigterm:
            signal.signal(signal.SIGTERM, prev_handler)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t_start
    if preempt.is_set():
        log_fn(f"SIGTERM at step {cur}: checkpointing and exiting")
    if mgr is not None:
        if steps_run and (cur % epoch_size != 0 or preempt.is_set()):
            mgr.save(state, step=cur)
    if metrics_writer is not None:
        metrics_writer.close()
    return FitResult(state=state, steps_run=steps_run,
                     audio_seconds_per_second=steps_run * audio_s_per_step / max(elapsed, 1e-9),
                     history=history, preempted=preempt.is_set())
