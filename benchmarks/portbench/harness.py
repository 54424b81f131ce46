"""What every cell shares: the run's context, the port's model and trainer
built as its CLIs build them, the first training steps read on both sides,
the traced window, and the result line.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import check, inputs, reference, trace, trunks

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "artgraph_tpu")
CHECK_STEPS = 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Run:
    """One run of one cell."""
    cell: str
    workload: dict
    cfg: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t_start: float
    manifest: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)

    @property
    def batch(self) -> int:
        return self.workload["batch"]

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans.setdefault(name, []).append((t0, t1))

    def stamp(self, what: str) -> None:
        """A set-up milestone on standard error: seconds since the start."""
        print(f"setup {time.perf_counter() - self.t_start:8.3f} s {what}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_run(cell: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, manifest: dict | None = None,
             cfg_override: dict | None = None) -> Run:
    """The cell's run from BENCHMARK.json (or `manifest`), its workload file
    and its configuration file."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    workload = load_json(BENCH_DIR / "workloads" / f"{cell}.json")
    cfgs = {c["name"]: c for c in manifest["configs"]}
    cfg = cfg_override or load_json(ROOT / cfgs[cells[cell]["config"]]["file"])
    return Run(cell, workload, cfg, seed, seconds, traced,
               torch.device(device), t_start, manifest)


# --- the program, built as its CLIs build it --------------------------------

def program_model(run: Run, weights: dict, train: bool):
    """The port's fusion model of the configuration on the run's device,
    with the seeded weights (its unused timm head keeps its own)."""
    cfg = run.cfg
    cls = trunks.get(cfg).fusion_class()
    with torch.device(run.device):
        model = cls(emb_size=cfg["emb_size"],
                    num_classes=dict(cfg["num_classes"]),
                    dropout=cfg["dropout"],
                    dtype=getattr(torch, cfg["compute_dtype"]))
    inputs.load_weights(model, weights)
    return model.train(train)


def program_trainer(run: Run, model, trainer_seed: int):
    """The Trainer as train_new_multimodal_multitask builds it."""
    from artgraph_tpu_torch.cli._common import multi_task_loss
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.train.trainer import Trainer, adam
    cfg = run.cfg
    w = cfg["loss_weights"]
    return Trainer(model=model, optimizer=adam(cfg["optimizer"]["lr"]),
                   compute_loss=multi_task_loss(None, None, w["style"],
                                                w["genre"], run.device),
                   transform_type=cfg["transform"], device=run.device,
                   seed=trainer_seed, forward_inputs=image_and_embeddings)


def seeded_weights(run: Run) -> dict:
    """The run's weights for every parameter of the plain model."""
    with torch.device("meta"):
        shapes = inputs.parameter_shapes(reference.PlainFusion(run.cfg))
    return inputs.make_weights(shapes, run.seed, run.device, run.cfg)


def apply_env(run: Run) -> None:
    for key, value in run.cfg.get("env", {}).items():
        os.environ[key] = value


# --- the first training steps, read on both sides ---------------------------

def program_step_readings(run: Run, trainer, loader, weights: dict
                          ) -> check.TrainReadings:
    """Train CHECK_STEPS one-batch epochs through `trainer.train_epoch` on
    `loader` (a staged loader): each step's loss, the first gradient from
    Adam's state after step 1, and each leaf's change after the last."""
    out = check.TrainReadings()
    params = dict(trainer.model.named_parameters())
    beta1 = run.cfg["optimizer"]["betas"][0]
    for step in range(CHECK_STEPS):
        out.losses.append(float(trainer.train_epoch(loader)["loss"]))
        if step == 0:
            # a step that left the optimizer's state unset reads 0
            state = trainer.optimizer.state
            out.grad = _norms({n: state.get(params[n], {}).get(
                "exp_avg", torch.zeros(())) / (1 - beta1) for n in weights})
    out.change = _norms({n: params[n].detach() - w
                         for n, w in weights.items()})
    return out


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([tensors[n].double().norm() for n in names])
    return dict(zip(names, values.tolist()))


def reference_step_readings(run: Run, batches: list, trainer_seed: int,
                            precision: str = "f32", fault: str | None = None
                            ) -> check.TrainReadings:
    """The plain model's first CHECK_STEPS steps on `batches` [(images u8,
    emb_style, emb_genre, labels)] numpy, from the run's weights, its dropout
    drawn as the program's trainer draws it. `fault="half_batch"`: each
    loss is the mean over the first half of the batch; "answer_altered":
    every image's style logits moved one class on."""
    cfg = run.cfg
    model = reference.PlainFusion(cfg).to(run.device)
    weights = seeded_weights(run)
    inputs.load_weights(model, weights)
    p = reference.Precision(precision)
    opt_cfg = cfg["optimizer"]
    opt = reference.Adam(model.parameters(), opt_cfg["lr"],
                         opt_cfg["betas"], opt_cfg["eps"])
    params = dict(model.named_parameters())
    out = check.TrainReadings()
    _seed_dropout(run, trainer_seed)
    rows = run.batch // 2 if fault == "half_batch" else None
    with reference.plain_math():
        for step, batch in enumerate(batches[:CHECK_STEPS]):
            img, es, eg, labels = (torch.from_numpy(np.ascontiguousarray(b))
                                   .to(run.device) for b in batch)
            for q in model.parameters():
                q.grad = None
            logits = model(img, es, eg, p, train=True)
            if fault == "answer_altered":
                logits = [logits[0].roll(1, dims=1), *logits[1:]]
            loss = reference.fusion_loss(cfg, logits, labels, rows)
            loss.backward()
            out.losses.append(float(loss.detach()))
            if step == 0:
                out.grad = _norms({n: params[n].grad for n in weights})
            opt.step()
    out.change = _norms({n: params[n].detach() - w
                         for n, w in weights.items()})
    return out


def _seed_dropout(run: Run, trainer_seed: int) -> None:
    """The default generator as the program's Trainer seeds it."""
    if run.device.type == "cuda":
        with torch.cuda.device(run.device):
            torch.cuda.manual_seed(trainer_seed)
    else:
        torch.manual_seed(trainer_seed)


def free_device(run: Run) -> None:
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()


# --- the traced window -------------------------------------------------------

class Tracer:
    """torch.profiler over one part of the window, named WINDOW_MARK; off
    unless the run is traced. The profiler starts with a short pre-roll of
    device work outside the mark: a trace can miss the device's first
    events."""

    def __init__(self, run: Run):
        self.run = run
        self.prof = None
        self.events: list | None = None
        self.samples = 0.0
        self.seconds = 0.0
        self.steps = 0

    @contextlib.contextmanager
    def part(self):
        if not self.run.traced:
            yield self
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.run.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        a = torch.ones(256, 256, device=self.run.device)
        for _ in range(20):
            a = a @ a * 1e-3
        self.run.sync()
        t0 = time.perf_counter()
        with record_function(trace.WINDOW_MARK):
            yield self
            self.run.sync()
        self.seconds = time.perf_counter() - t0
        self.prof.stop()

    def read(self) -> None:
        """The trace's events (after the window; the file is deleted)."""
        if self.prof is None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            self.events = trace.load_events(path)
        self.prof = None


@dataclass
class View:
    """What a per-layer metric reads."""
    run: Run
    peaks: dict | None
    samples: float            # in the traced part
    seconds: float            # of the traced part, host clock
    steps: int                # training steps (batches) in the traced part
    window: tuple             # the measured window, perf_counter seconds
    events: list | None = None
    work: list | None = None  # device work inside the traced part
    t0: float = 0.0           # the traced part, trace microseconds
    t1: float = 0.0


def make_view(run: Run, tracer: Tracer, window: tuple) -> View:
    peaks = None
    if run.device.type == "cuda":
        peaks = load_json(Path(__file__).with_name("peaks.json")).get(
            torch.cuda.get_device_name(run.device))
    view = View(run, peaks, tracer.samples, tracer.seconds, tracer.steps,
                window)
    if tracer.events is not None:
        view.events = tracer.events
        view.t0, view.t1 = trace.window(tracer.events)
        view.work = trace.device_work(tracer.events, view.t0, view.t1)
    return view


def cell_metrics(manifest: dict, cell: str, traced: bool) -> list:
    """The metric entries a run of `cell` reports: end-to-end ones untraced,
    per-layer ones traced, each where it lists the cell or, without a
    list, in every cell that reports the metric it moves."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metric(name: str, view: View):
    """benchmarks/metrics/<name>.py's read(view): a number, or None when it
    found nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(view)
    return None if value is None else float(value)


def breakdown(view: View) -> dict | None:
    if view.work is None:
        return None
    return {"device_ops": trace.top_ops(view.work),
            "idle_gaps": trace.idle_gaps(view.events, view.work, view.t0,
                                         view.t1)}


def p95(values: list) -> float:
    return statistics.quantiles(values, n=20)[-1]


# --- the result line ---------------------------------------------------------

@dataclass
class Outcome:
    """What an entry hands back."""
    e2e: dict                 # name -> value
    numbers: dict             # check name -> value
    attempted: int            # whole samples or images in the window
    failed: int
    window: tuple             # perf_counter (start, end)
    memory_peak: int
    tracer: Tracer


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result(run: Run, outcome: Outcome) -> tuple[dict, list]:
    """(the last line's object, the stderr lines of the checks)."""
    limits = run.workload.get("limits", {})
    correct, checks = check.judge(outcome.numbers, limits)
    units = {m["name"]: m["unit"] for m in (*run.manifest["end_to_end"],
                                            *run.manifest["per_layer"])}
    metrics = {}
    view = make_view(run, outcome.tracer, outcome.window)
    for m in cell_metrics(run.manifest, run.cell, run.traced):
        name = m["name"]
        value = (read_metric(name, view) if run.traced
                 else outcome.e2e.get(name))
        if value is not None and math.isfinite(value):
            metrics[name] = {"value": value, "unit": units[name]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(outcome.memory_peak)}
    line = {"correct": correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    if run.traced and view.work is not None:
        device["busy_s"] = trace.busy(view.work) / 1e6
        device["window_s"] = (view.t1 - view.t0) / 1e6
        line["breakdown"] = breakdown(view)
    line["checks"] = checks
    lines = [f"reading {k}: {v!r}" for k, v in outcome.numbers.items()
             if k not in checks]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in checks.items()]
    return line, lines


def train_window(run: Run, trainer, loader, tracer: Tracer
                 ) -> tuple[int, float, float]:
    """Whole epochs of `trainer.train_epoch(loader)` until `run.seconds`
    have passed, the first one traced in a traced run: (samples, window
    start, window end). Each epoch ends in the Trainer's host read of its
    metrics, a sync."""
    samples = 0
    run.sync()
    start = time.perf_counter()
    with tracer.part():
        m = trainer.train_epoch(loader)
        tracer.samples, tracer.steps = m["examples"], len(loader)
    samples += round(m["examples"])
    while time.perf_counter() - start < run.seconds:
        samples += round(trainer.train_epoch(loader)["examples"])
    return samples, start, time.perf_counter()


def memory_peak(run: Run) -> int:
    if run.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(run.device))
