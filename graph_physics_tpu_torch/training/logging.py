"""Metrics logging: JSONL always, wandb when asked.

Counterpart of graph_physics_tpu/training/logging.py:MetricsLogger (:17):
one record per call in ``out_dir/<run_name>.metrics.jsonl`` (the trainer
passes ``out_dir/run_name``), with the step and the seconds since the
logger started. ``use_wandb`` imports wandb when the logger is made and
raises an ImportError naming ``--use_wandb`` where it is missing; a run
id (``run_id``) round-trips through the checkpoints, so a resumed run
reattaches to its wandb run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "run", use_wandb: bool = False,
                 wandb_config: Optional[Dict[str, Any]] = None,
                 resume_id: Optional[str] = None, enabled: bool = True):
        self.enabled = enabled
        self._t0 = time.time()
        self.wandb = None
        self.run_id = resume_id
        self._f = None
        if not enabled:
            self.path = None
            return
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{run_name}.metrics.jsonl")
        self._f = open(self.path, "a")
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                raise ImportError("--use_wandb needs wandb, which is not installed") from e
            self.wandb = wandb.init(
                project=(wandb_config or {}).get("project", "graph-physics-tpu"),
                name=run_name, config=wandb_config, id=resume_id,
                resume="allow" if resume_id else None)
            self.run_id = self.wandb.id

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self.wandb is not None:
            self.wandb.finish()
