"""Serving through `predict`'s batch loop: one caller in a closed loop, each
batch handed over as host arrays, moved to the device as `cli/predict.py`
moves it, classified by its `infer` (normalize, then the model, under
inference_mode, eager) and read back as numpy logits.

Set-up: the seeded pool of host batches and weights, the port's model in
eval mode, and the warm-up batches. The window: batches, cycling over the
pool, for `--seconds`; each batch's latency runs from the hand-over of the
host arrays to the logits on the host. The check: a seeded sample of the
served batches against the plain model's forward on the same inputs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, harness as h, inputs, reference


def _setup(run: h.Run):
    from artgraph_tpu_torch.cli.predict import infer
    h.apply_env(run)
    wl, B = run.workload, run.batch
    run.stamp("imports")
    pool = inputs.make_split(run.cfg, wl["pool_batches"] * B, run.seed,
                             run.device, tag="pool")
    model = h.program_model(run, h.seeded_weights(run), train=False)
    transform = run.cfg["transform"]

    def serve(serial: int):
        """One batch: (logits [style, genre] numpy, t_handover, t_call,
        t_return, t_host)."""
        lo = (serial % wl["pool_batches"]) * B
        t0 = time.perf_counter()
        images = torch.from_numpy(pool["images"][lo:lo + B]).to(run.device)
        embs = tuple(torch.from_numpy(pool[k][lo:lo + B]).to(run.device)
                     for k in ("emb_style", "emb_genre"))
        t1 = time.perf_counter()
        outputs = infer(model, images, *embs, transform_type=transform)
        t2 = time.perf_counter()
        logits = [o.cpu().numpy() for o in outputs]
        return logits, t0, t1, t2, time.perf_counter()

    run.stamp("pool, weights, model")
    for serial in range(wl["warmup_batches"]):
        serve(serial)
    run.stamp("warm-up batches")
    return pool, model, serve


def _window(run: h.Run, serve, tracer: h.Tracer):
    served, latency = [], []

    def one():
        logits, t0, t1, t2, t3 = serve(len(served))
        served.append(logits)
        latency.append(t3 - t0)
        run.span("enqueue", t1, t2)

    run.sync()
    start = time.perf_counter()
    with tracer.part():
        for _ in range(run.workload["traced_batches"]):
            one()
    tracer.steps = len(served)
    tracer.samples = float(len(served) * run.batch)
    while time.perf_counter() - start < run.seconds:
        one()
    return served, latency, start, time.perf_counter()


def _reference_logits(run: h.Run, pool: dict, serials: list,
                      precision: str = "f32") -> list:
    """The plain model's logits, eval mode, on the pool batches of
    `serials`: [style [rows, C], genre [rows, C']]."""
    model = reference.PlainFusion(run.cfg).to(run.device).eval()
    inputs.load_weights(model, h.seeded_weights(run))
    p = reference.Precision(precision)
    B, P = run.batch, run.workload["pool_batches"]
    out = [[], []]
    with torch.no_grad(), reference.plain_math():
        for serial in serials:
            lo = (serial % P) * B
            args = (torch.from_numpy(pool[k][lo:lo + B]).to(run.device)
                    for k in ("images", "emb_style", "emb_genre"))
            for i, logits in enumerate(model(*args, p, train=False)):
                out[i].append(logits.cpu().numpy())
    return [np.concatenate(o) for o in out]


def _sample(run: h.Run, n_served: int) -> list:
    k = min(run.workload["check_batches"], n_served)
    return sorted(inputs.rng(run.seed, "check_sample").choice(
        n_served, k, replace=False).tolist())


def _program_logits(served: list, serials: list) -> list:
    return [np.concatenate([served[s][i] for s in serials]) for i in (0, 1)]


def run(run: h.Run) -> h.Outcome:
    pool, model, serve = _setup(run)
    tracer = h.Tracer(run)
    served, latency, start, end = _window(run, serve, tracer)
    setup_s = start - run.t_start
    peak = h.memory_peak(run)
    del model, serve
    h.free_device(run)
    serials = _sample(run, len(served))
    numbers = check.compare_logits(_program_logits(served, serials),
                                   _reference_logits(run, pool, serials))
    tracer.read()
    images = len(served) * run.batch
    return h.Outcome({"serve_img_per_s": images / (end - start),
                      "serve_p95_ms": 1e3 * h.p95(latency),
                      "setup_s": setup_s},
                     numbers, images, 0, (start, end), peak, tracer)


def calibrate(run: h.Run) -> dict:
    """The check's reading of the program (a window of the workload's
    check_batches batches) and of the fp8 control, each against the f32
    reference."""
    pool, model, serve = _setup(run)
    served = [serve(s)[0] for s in range(run.workload["check_batches"])]
    del model, serve
    h.free_device(run)
    serials = list(range(len(served)))
    ref = _reference_logits(run, pool, serials)
    return {"program": check.compare_logits(_program_logits(served, serials),
                                            ref),
            "control_fp8": check.compare_logits(
                _reference_logits(run, pool, serials, "fp8"), ref)}
