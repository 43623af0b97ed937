"""Structured JSONL run metrics (counterpart of
``neuralmelting_tpu.utils.metrics``): machine-readable events (moves,
exchange acceptances, wall time) beside the .thrm/.traj text outputs."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL event log; no-op when path is None."""

    def __init__(self, path: Optional[str] = None, run_id: str = ""):
        self.path = path
        self.run_id = run_id
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields):
        if not self.path:
            return
        rec = {"t": round(time.time() - self._t0, 3), "event": event}
        if self.run_id:
            rec["run"] = self.run_id
        rec.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    @staticmethod
    def read(path: str):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
