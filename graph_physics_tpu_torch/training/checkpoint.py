"""Checkpoints and resume: ``torch.save`` of one dict per step.

Counterpart of graph_physics_tpu/training/checkpoint.py, where orbax
writes the TrainState. Here step ``s`` lives in ``<directory>/<s>/`` as
``checkpoint.pt``, one dict:

  * ``simulator``: the Simulator's ``state_dict()`` under the reference
    names (``model.processor_list.{i}...``), the normalizers'
    accumulators (``_output_normalizer._acc_sum`` ...) among them, so
    graph_physics_tpu/utils/convert.py's bridges still apply;
  * ``optimizer``: the AdamW moments, the update count and the gradient
    accumulation buffers (schedule.ClippedAdamW.state_dict);
  * ``step``: the train state's step (batches taken);
  * ``metadata``: the JSON metadata (``epoch``, ``run_id``, ``config``).

The retention policy is orbax's as make_manager (:28) sets it: the
``max_to_keep`` (3) latest steps, or with ``best_metric`` the
``max_to_keep`` best by that metric (``metrics.json`` beside the
checkpoint) together with every step saved without metrics.
``save_simulator``/``load_simulator`` (:103-119) write and read the
model-only artifact (parameters and normalizer statistics).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

CHECKPOINT = "checkpoint.pt"
METRICS = "metrics.json"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


class CheckpointManager:
    """Step directories under ``directory`` and the retention policy."""

    def __init__(self, directory: str, max_to_keep: int = 3, best_metric: Optional[str] = None,
                 best_mode: str = "min"):
        self.directory = _abs(directory)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d,
                                                                     CHECKPOINT)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Optional[Dict[str, float]]:
        path = os.path.join(self._path(step), METRICS)
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _sorted_by_metric(self, steps: List[int]) -> List[int]:
        """Steps with metrics, worst first (orbax's order: a stable sort,
        descending in ``min`` mode)."""
        scored = [(s, self.metrics(s)) for s in steps]
        scored = [(s, m[self.best_metric]) for s, m in scored if m is not None]
        ordered = sorted(scored, key=lambda sm: sm[1], reverse=self.best_mode == "min")
        return [s for s, _ in ordered]

    def best_step(self) -> Optional[int]:
        ordered = self._sorted_by_metric(self.all_steps()) if self.best_metric else []
        return ordered[-1] if ordered else None

    def save(self, step: int, payload: Dict[str, Any],
             metrics: Optional[Dict[str, float]] = None) -> None:
        final = self._path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, CHECKPOINT))
        if metrics is not None:
            with open(os.path.join(tmp, METRICS), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for s in self._steps_to_remove():
            shutil.rmtree(self._path(s), ignore_errors=True)

    def _steps_to_remove(self) -> List[int]:
        steps = self.all_steps()
        if self.best_metric is None:
            return steps[:-self.max_to_keep] if self.max_to_keep else []
        ordered = self._sorted_by_metric(steps)
        return ordered[:max(len(ordered) - self.max_to_keep, 0)]

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(os.path.join(self._path(step), CHECKPOINT), map_location="cpu",
                          weights_only=False)

    def wait_until_finished(self) -> None:
        """Saves are synchronous (orbax's interface kept for the trainer)."""


def make_manager(directory: str, max_to_keep: int = 3, best_metric: Optional[str] = None,
                 best_mode: str = "min") -> CheckpointManager:
    """checkpoint.py:make_manager (:28)."""
    return CheckpointManager(directory, max_to_keep, best_metric, best_mode)


def save_checkpoint(manager: CheckpointManager, simulator, state, step: int,
                    metadata: Optional[Dict[str, Any]] = None,
                    metrics: Optional[Dict[str, float]] = None) -> None:
    """Save the simulator (weights and normalizers), the optimizer and the
    step of ``state`` (a training/step.TrainState) as ``step``."""
    manager.save(step, {"simulator": simulator.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "step": int(state.step), "metadata": metadata or {}}, metrics)


def restore_checkpoint(manager: CheckpointManager, simulator, state=None,
                       step: Optional[int] = None) -> Dict[str, Any]:
    """Load step ``step`` (the latest by default) into ``simulator`` and,
    when given, ``state``; returns the metadata."""
    payload = manager.restore(step)
    simulator.load_state_dict(payload["simulator"])
    if state is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
    return payload["metadata"]


def save_simulator(path: str, simulator, extra: Optional[Dict] = None) -> None:
    """The model-only artifact: parameters and normalizer statistics
    (checkpoint.py:save_simulator :103), with ``extra.json`` beside it."""
    path = _abs(path)
    os.makedirs(path, exist_ok=True)
    torch.save(simulator.state_dict(), os.path.join(path, "simulator.pt"))
    if extra is not None:
        with open(os.path.join(path, "extra.json"), "w") as f:
            json.dump(extra, f)


def load_simulator(path: str, simulator) -> None:
    """checkpoint.py:load_simulator (:114) into ``simulator``."""
    simulator.load_state_dict(torch.load(os.path.join(_abs(path), "simulator.pt"),
                                         map_location="cpu"))
