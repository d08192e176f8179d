"""Training logs (the port's own copy of the scalar and JSON writers of
``enarf_gan_tpu/utils/logging.py``; the PNG grid needs PIL and waits).

``tensorboardX`` is imported inside ``MetricsWriter`` and used when present;
``metrics.jsonl`` is written always.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsWriter:
    """Scalar writer: tensorboardX when importable, and metrics.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            import tensorboardX
            self._tbx = tensorboardX.SummaryWriter(log_dir)
        except Exception:
            self._tbx = None

    def scalar(self, iteration: int, value, name: str):
        value = float(np.asarray(value))
        if self._tbx is not None:
            self._tbx.add_scalar(f"metrics/{name}", value, iteration)
        self._jsonl.write(json.dumps({"iter": iteration, name: value,
                                      "t": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tbx is not None:
            self._tbx.close()
        self._jsonl.close()


class JsonLog:
    """Metrics per validation interval, kept in one JSON file."""

    def __init__(self, path: str):
        self.path = path
        self.log: Dict = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self.log = json.load(f)
            except Exception:
                self.log = {}

    def update(self, iteration: int, entry: Dict):
        self.log[str(iteration)] = entry
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.log, f)
