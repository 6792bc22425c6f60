"""Profiling hooks (counterpart of graph_physics_tpu/utils/profiling.py):
a ``torch.profiler`` trace where JAX starts ``jax.profiler``, and a
per-step throughput counter.

:class:`StepTrace` is what the trainer's ``profile_dir`` runs: it traces
the host and, on a card, the device from the start of the second step to
the end of the fourth (JAX's fit skips the compile step the same way,
trainer.py:513-558) and writes a Chrome trace to ``profile_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str], device="cuda") -> Iterator[None]:
    """A torch.profiler trace of the block written to ``log_dir``; no-op
    when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    with StepTrace(log_dir, device) as t:
        t.start()
        yield


class StepTrace:
    """``start()``/``stop()`` around the traced steps; ``stop`` writes
    ``<log_dir>/trace_<pid>.json`` (a Chrome trace)."""

    def __init__(self, log_dir: str, device="cuda"):
        self.log_dir = log_dir
        self.device = device
        self._prof = None
        self.path = None

    def start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = torch.profiler.profile(activities=_activities(self.device))
        self._prof.__enter__()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class Throughput:
    """Per-step graphs/sec and a step-time EMA (profiling.py:Throughput)."""

    def __init__(self, ema: float = 0.98):
        self._ema = ema
        self._t = None
        self.step_time = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._t is not None:
            dt = now - self._t
            self.step_time = (dt if self.step_time is None
                              else self._ema * self.step_time + (1 - self._ema) * dt)
        self._t = now
        return self.step_time

    def graphs_per_sec(self, batch_size: int) -> Optional[float]:
        return batch_size / self.step_time if self.step_time else None
