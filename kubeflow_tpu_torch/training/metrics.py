"""Training metrics: in-process writer + scrape-free export (a copy of
``kubeflow_tpu.training.metrics``, which is pure Python; the port keeps
its own so that it imports nothing of the JAX package).

Replaces the reference's Katib metrics-collector *sidecar* (stdout regex
parsing -> gRPC -> MySQL; SURVEY.md §2.3) with a native path: the training
loop writes typed scalars to a JSONL file / in-memory buffer that the tuner
and observability layers read directly. No stdout scraping.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any


class MetricsWriter:
    """Appends {"step": n, "ts": t, name: value, ...} records to a JSONL file
    (and keeps them in memory). Thread-safe; file is the cross-process contract
    used by the tune/ trial controller."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, step: int, **metrics: Any):
        rec = {"step": int(step), "ts": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        with self._lock:
            self.records.append(rec)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        return rec

    def latest(self, name: str):
        for rec in reversed(self.records):
            if name in rec:
                return rec[name]
        return None


def read_metrics(path: str) -> list[dict]:
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # partial concurrent write; next read gets it
    return out


def objective_from_metrics(records: list[dict], name: str, mode: str = "min"):
    vals = [r[name] for r in records if name in r]
    if not vals:
        return None
    return min(vals) if mode == "min" else max(vals)
