"""Observability of training: metrics persistence, device traces, step
timing.

The JAX package's ``utils/observability.py`` (the reference's
LoggingTensorHook and TF summaries):

* :class:`MetricsWriter` -- an append-only JSONL of the logged steps in the
  experiment dir (``metrics.jsonl``), the records of the JAX package's;
  read back with :func:`load_metrics`;
* :func:`trace` -- a ``torch.profiler`` scope (CPU and, where there is one,
  CUDA activity) that writes a Chrome trace under ``<exp_dir>/profile/``
  (``chrome://tracing`` or Perfetto open it; the JAX package writes a
  TensorBoard trace there with ``jax.profiler``);
* :class:`StepTimer` -- steps/s and audio-seconds/s since the last lap.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional


class MetricsWriter:
    def __init__(self, exp_dir: str, name: str = "metrics.jsonl"):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, name)
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, float], **extra) -> None:
        rec = {"step": int(step), "time": time.time(), **extra}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def load_metrics(exp_dir: str, name: str = "metrics.jsonl") -> List[Dict]:
    """The records :class:`MetricsWriter` appended, in order ([] if none)."""
    path = os.path.join(exp_dir, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@contextlib.contextmanager
def trace(exp_dir: str, enabled: bool = True,
          name: Optional[str] = None) -> Iterator[Optional[object]]:
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``<exp_dir>/profile/<name or trace_<pid>_<time>>.json``. Yields the
    profiler (``None`` when disabled), whose ``trace_path`` is set on exit.
    CUDA activity is recorded where a card is present."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(exp_dir, "profile")
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(out, (name or f"trace_{os.getpid()}_{int(time.time())}") + ".json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


class StepTimer:
    """Throughput counters: steps/s and audio-seconds/s since the last lap."""

    def __init__(self, audio_seconds_per_step: float):
        self.audio_s = audio_seconds_per_step
        self._t = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def lap(self) -> Dict[str, float]:
        now = time.perf_counter()
        dt = max(now - self._t, 1e-9)
        out = {
            "steps_per_s": self._steps / dt,
            "audio_s_per_s": self._steps * self.audio_s / dt,
        }
        self._t = now
        self._steps = 0
        return out
