"""Training metrics persistence: an append-only JSONL of the logged steps in
the experiment dir (``metrics.jsonl``), the same records as the JAX
package's ``MetricsWriter``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


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

