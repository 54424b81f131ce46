"""Tracing: the port's spans and counters, and an exporter around
torch.profiler (the JAX package's artgraph_tpu/profiling.py has `trace` and
`annotate` too).

  * `trace(logdir)`: a context manager around torch.profiler that records
    the host and, on a GPU, the device activity inside it and writes a
    Chrome trace (`trace.json`, for chrome://tracing or Perfetto) into
    logdir on exit.
  * `annotate(name)`: a span, a named host range of the trace on the same
    clock as the device's kernels. It records only while the calling
    thread's profiler records; otherwise it returns one shared no-op
    context manager and costs one flag check.
  * `count(name, n)` and `counters()`: process-wide integer counters that
    add only while the calling thread's profiler records, so after a run
    they hold what its profiled part did. They take no lock: the work they
    count is issued from the one thread that a profiler records.

Nothing turns them on but a profiler: `trace()`, or any
torch.profiler.profile around the work. The profiler's state is per
thread, and a thread the profiler does not record emits no span and counts
nothing.

The port's spans, each on the thread that launches the work:

  ag.predict.infer        cli/predict.py `infer`: the normalize and the
                          model's forward of one serving batch
  ag.trainer.replay       Trainer `_run`: a step's copies into the graph's
                          static inputs, the graph's replay and the launch
                          counters' update
  ag.trainer.capture      Trainer `_warm_up_and_capture`: the eager
                          warm-up step of a new graph key and its capture
  ag.trainer.eager_step   every eager training step: a BatchNorm model's
                          ragged tail, every step off cuda or under gloo,
                          and `Trainer.train_step`
  ag.trainer.wait_batch   Trainer `_prefetched`: the step's wait for the
                          next batch from the host loader's queue, and
                          at the epoch's end for the queue's last item

The port's counter:

  weight_cast_bytes       the bytes of the copies of f32 weight matrices
                          in the compute dtype that eager forwards and
                          backwards make (ops/attention.py `cast_weight`,
                          which the ViT's weights and the block ops' CUDA
                          and plain versions cast through; ResNet's convs
                          and the conv+BN unit cast theirs uncounted)
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch

_OFF = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}
_enabled = torch.autograd._profiler_enabled


def recording() -> bool:
    """Whether the calling thread's torch profiler records."""
    return _enabled()


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
    """A span named `name` (torch.profiler.record_function) while the
    calling thread's profiler records, else a shared no-op."""
    if _enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add n to the counter `name` while the calling thread's profiler
    records."""
    if _enabled():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTERS)
