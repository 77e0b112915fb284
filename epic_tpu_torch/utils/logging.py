"""Experiment logging: an append-only ``metrics.jsonl`` (one JSON record per
call, flushed, so it survives a killed process) and, when asked for and
importable, wandb."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, project: str = "epic_tpu",
                 use_wandb: bool = False, config: Optional[Dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, config=config)
            except Exception:  # no package, no credentials: the JSONL only
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        """One record: the time, ``step`` and the metrics (tensors and
        numpy scalars as floats)."""
        rec = {"t": time.time(), "step": step, **{
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, name: str, path: str, step: Optional[int] = None):
        self.log({f"image/{name}": path}, step)
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(path)}, step=step)

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
