"""Experiment tracking with the reference's MLflow surface.

The port's own copy of artgraph_tpu/tracking/mlflow_adapter.py (that module
imports no JAX, but the port imports nothing of the JAX package). The
reference logs per-epoch loss/acc metrics through decorators and all
argparse params per experiment (ref: src/utils.py:238-266), opt-in via the
-t/--tracking flag; the metric and param names and the decorator API are
the same. When the mlflow package is unavailable (the GPU hosts the port
runs on have none), a minimal file-store backend writes the layout mlflow's
FileStore uses, mlruns/<exp>/<run_id>/{params,metrics,meta.yaml}, line for
line as the JAX package's fallback writes it, so runs of either package
read alike.

Values are read on the host when they are logged: a 0-d tensor through
`.item()`. The trainers log once per epoch, after the epoch's one read of
its device totals, so tracking adds no synchronization and no work inside
a step. Over a data mesh (parallel/mesh.py) only rank 0 logs.
"""
from __future__ import annotations

import os
import time
import uuid
from functools import wraps

try:
    import mlflow as _mlflow
except ImportError:  # file-store fallback below
    _mlflow = None


def _as_float(value) -> float:
    item = getattr(value, "item", None)
    return float(item()) if callable(item) else float(value)


class _FileStore:
    """Tiny MLflow-FileStore-compatible writer (params + metrics only)."""

    def __init__(self, root: str = "mlruns"):
        self.root = root
        self.experiment = "Default"
        self._run_dir = None

    def set_experiment(self, name: str) -> None:
        self.experiment = name
        self._run_dir = None

    def _ensure_run(self) -> str:
        if self._run_dir is None:
            run_id = uuid.uuid4().hex
            self._run_dir = os.path.join(self.root, self.experiment, run_id)
            for sub in ("params", "metrics"):
                os.makedirs(os.path.join(self._run_dir, sub), exist_ok=True)
            with open(os.path.join(self._run_dir, "meta.yaml"), "w") as f:
                f.write(f"run_id: {run_id}\nexperiment: {self.experiment}\n"
                        f"start_time: {int(time.time() * 1000)}\n")
        return self._run_dir

    def log_param(self, key: str, value) -> None:
        run_dir = self._ensure_run()
        with open(os.path.join(run_dir, "params", key.replace("/", "_")),
                  "w") as f:
            f.write(str(value))

    def log_metric(self, key: str, value, step: int = 0) -> None:
        run_dir = self._ensure_run()
        path = os.path.join(run_dir, "metrics", key.replace("/", "_"))
        with open(path, "a") as f:
            f.write(f"{int(time.time() * 1000)} {_as_float(value)} {step}\n")


_store = _FileStore()


def _silent() -> bool:
    """A data-mesh rank other than 0: it logs nothing."""
    from artgraph_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return mesh is not None and mesh.rank != 0


def set_experiment(name: str) -> None:
    if _silent():
        return
    if _mlflow is not None:
        _mlflow.set_experiment(name)
    else:
        _store.set_experiment(name)


def log_param(key: str, value) -> None:
    if _silent():
        return
    if _mlflow is not None:
        _mlflow.log_param(key, value)
    else:
        _store.log_param(key, value)


def log_metric(key: str, value, step: int = 0) -> None:
    if _silent():
        return
    if _mlflow is not None:
        _mlflow.log_metric(key, _as_float(value), step=step)
    else:
        _store.log_metric(key, value, step=step)


def tracker(is_tracking: bool, type: str):
    """Per-epoch (loss, acc, epoch) logger (ref: src/utils.py:238-248)."""

    def decorator(fun):
        @wraps(fun)
        def wrapper(*args, **kwargs):
            loss, acc, epoch = fun(*args, **kwargs)
            if is_tracking:
                log_metric(f"{type} loss", loss, step=epoch)
                log_metric(f"{type} acc", _as_float(acc), step=epoch)
            return loss, acc, epoch

        return wrapper

    return decorator


def tracker_multitask(is_tracking: bool, type: str):
    """Per-epoch (loss, acc_style, acc_genre, epoch) logger
    (ref: src/utils.py:250-261)."""

    def decorator(fun):
        @wraps(fun)
        def wrapper(*args, **kwargs):
            loss, acc_style, acc_genre, epoch = fun(*args, **kwargs)
            if is_tracking:
                log_metric(f"{type} loss", loss, step=epoch)
                log_metric(f"{type} acc style", _as_float(acc_style),
                           step=epoch)
                log_metric(f"{type} acc genre", _as_float(acc_genre),
                           step=epoch)
            return loss, acc_style, acc_genre, epoch

        return wrapper

    return decorator


def track_params(args) -> None:
    """Log every argparse arg under the --exp experiment
    (ref: src/utils.py:263-266)."""
    set_experiment(args.exp)
    for arg in vars(args):
        log_param(arg, getattr(args, arg))
