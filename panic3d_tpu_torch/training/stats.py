"""Training statistics: moment accumulators + jsonl reporting, a copy of
panic3d_tpu/training/stats.py (numpy only; the port imports nothing of the
JAX package).

Role of `src/torch_utils/training_stats.py` (report/Collector) and the
stats.jsonl writer (training_loop_v0.py:510-523). The port trains in one
process, whose train step returns the batch's loss means, so the collector
is pure host code.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class Collector:
    def __init__(self):
        self._num = defaultdict(int)
        self._sum = defaultdict(float)
        self._sumsq = defaultdict(float)

    def report(self, name: str, value):
        v = float(np.asarray(value))
        if not np.isfinite(v):
            return
        self._num[name] += 1
        self._sum[name] += v
        self._sumsq[name] += v * v

    def report_dict(self, stats: Dict[str, float]):
        for k, v in stats.items():
            self.report(k, v)

    def mean(self, name: str) -> float:
        n = self._num[name]
        return self._sum[name] / n if n else float("nan")

    def std(self, name: str) -> float:
        n = self._num[name]
        if n == 0:
            return float("nan")
        m = self.mean(name)
        return float(np.sqrt(max(self._sumsq[name] / n - m * m, 0.0)))

    def as_dict(self) -> Dict[str, dict]:
        return {
            k: {"num": self._num[k], "mean": self.mean(k), "std": self.std(k)}
            for k in self._num
        }

    def reset(self):
        self._num.clear()
        self._sum.clear()
        self._sumsq.clear()


class JsonlLogger:
    """stats.jsonl writer, one line per tick (training_loop_v0.py:510-517)."""

    def __init__(self, path: str):
        self._f = open(path, "at")

    def write(self, collector: Collector, **extra):
        line = dict(collector.as_dict())
        line.update(extra)
        line["timestamp"] = time.time()
        self._f.write(json.dumps(line) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardLogger:
    """TensorBoard event export (training_loop_v0.py:518-523 role).

    Rides the torch SummaryWriter baked into this venv; constructed only
    when the trainer is launched with --tensorboard, so runs without torch
    installed are unaffected."""

    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir=logdir)

    def write(self, collector: Collector, step: int):
        for name, d in collector.as_dict().items():
            self._w.add_scalar(name, d["mean"], global_step=step)
            if d["num"] > 1:
                self._w.add_scalar(f"{name}/std", d["std"], global_step=step)
        self._w.flush()

    def close(self):
        self._w.close()
