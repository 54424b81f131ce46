"""Tracing and timing utilities: port of artgraph_tpu/profiling.py.

  * `trace(logdir)`: a context manager around torch.profiler that records
    the host and, on a GPU, the device activity inside it and writes a
    Chrome trace (`trace.json`, for chrome://tracing or Perfetto) into
    logdir on exit.
  * `annotate(name)`: a named region inside a trace
    (torch.profiler.record_function).
  * `StepTimer`: a wall-clock images/sec meter with a warm-up skip, the JAX
    package's arithmetic. CUDA launches return before the work ends: the
    caller synchronizes the device (torch.cuda.synchronize(), or a host
    read of a step output) before each `stop()`, or the time measured is
    the launches'.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates (examples, seconds) across steps; reports images/sec."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps = warmup_steps
        self._steps = 0
        self._examples = 0.0
        self._seconds = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, examples: float) -> None:
        dt = time.perf_counter() - self._t0
        self._steps += 1
        if self._steps > self.warmup_steps:
            self._examples += examples
            self._seconds += dt

    @property
    def images_per_sec(self) -> float:
        return self._examples / self._seconds if self._seconds else 0.0
