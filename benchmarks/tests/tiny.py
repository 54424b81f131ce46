"""Tiny configurations and workloads for the CPU rehearsal of the cells:
the published files with test-only widths, depths and sizes (each trunk
module's TINY), and the port's trunk patched to build at them."""
from __future__ import annotations

import importlib
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from portbench import harness, trunks  # noqa: E402

TINY_WORKLOAD = {"batch": 4, "split_rows": 24, "warmup_epochs": 1,
                 "pool_batches": 3, "warmup_batches": 1, "traced_batches": 2,
                 "check_batches": 2, "jpeg_pool": 5, "jpeg_width": 160,
                 "jpeg_height": 120, "epoch_rows": 16, "eval_rows": 4,
                 "num_workers": 2}


def manifest() -> dict:
    """BENCHMARK.json, with the entries of each workload file that carries
    its own ("manifest_entries": a cell built and rehearsed here but not yet
    enrolled)."""
    m = harness.load_json(ROOT / "BENCHMARK.json")
    enrolled = {w["name"] for w in m["workloads"]}
    for path in sorted((BENCH / "workloads").glob("*.json")):
        spec = harness.load_json(path)
        if spec["name"] not in enrolled and "manifest_entries" in spec:
            for key, entries in spec["manifest_entries"].items():
                m[key] = m[key] + entries
    return m


def tiny_config(name: str) -> dict:
    cfg = harness.load_json(BENCH / "configs" / f"{name}.json")
    cfg.update(trunks.get(cfg).TINY)
    return cfg


def patch_trunks(monkeypatch, cfg: dict) -> None:
    """The port's fusion model of `cfg` builds its trunk at the tiny
    sizes."""
    trunks.get(cfg).patch_tiny(monkeypatch)


def tiny_run(cell: str, seed: int = 7, traced: bool = False,
             seconds: float = 0.0, limits: dict | None = None
             ) -> harness.Run:
    m = manifest()
    cfg_name = {w["name"]: w["config"] for w in m["workloads"]}[cell]
    cfg = tiny_config(cfg_name)
    workload = harness.load_json(BENCH / "workloads" / f"{cell}.json")
    if workload["entry"] == "train_jpeg":
        cfg["img_size"] = 224        # the port's loader resizes to 224
    run = harness.load_run(cell, seed, seconds, traced, "cpu",
                           time.perf_counter(), m, cfg)
    run.workload = {**run.workload, **TINY_WORKLOAD}
    if limits is not None:
        run.workload["limits"] = limits
    return run


def drive(monkeypatch, run: harness.Run, fault: str | None = None):
    """`run` through its entry with the port's trunk at the tiny sizes and
    the timed path broken by `fault` (break_timed_path): (the result line,
    its stderr lines)."""
    patch_trunks(monkeypatch, run.cfg)
    if fault is not None:
        break_timed_path(monkeypatch, fault, run.cfg)
    entry = importlib.import_module(
        f"portbench.entries.{run.workload['entry']}")
    return harness.result(run, entry.run(run))


def _altered_answers(logits):
    """The style logits of every image moved one class on."""
    return [logits[0].roll(1, dims=1), *logits[1:]]


def break_timed_path(monkeypatch, fault: str, cfg: dict) -> None:
    """A fault planted under the timed path: the optimizer step returns
    the state unchanged; the loss is the mean over half the batch; the
    answers altered where the configuration's fusion model and `infer`
    produce them; a decoded image altered."""
    import torch

    from artgraph_tpu_torch.cli import _common, predict
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, *a, **k: None)
    elif fault == "half_batch":
        ce = _common.cross_entropy

        def half(logits, labels, cw=None, mask=None):
            h = logits.shape[0] // 2
            return ce(logits[:h], labels[:h], cw,
                      None if mask is None else mask[:h])
        monkeypatch.setattr(_common, "cross_entropy", half)
    elif fault == "answer_altered":
        cls = trunks.get(cfg).fusion_class()
        fwd = cls.forward
        monkeypatch.setattr(cls, "forward", lambda self, *a, _f=fwd:
                            _altered_answers(_f(self, *a)))
        infer = predict.infer
        monkeypatch.setattr(predict, "infer", lambda *a, **k:
                            _altered_answers(infer(*a, **k)))
    elif fault == "image_altered":
        from artgraph_tpu_torch.data import datasets
        decode = datasets.decode_resize_uint8

        def altered(path):
            img = decode(path).copy()
            img[0, 0, 0] ^= 1
            return img
        monkeypatch.setattr(datasets, "decode_resize_uint8", altered)
    else:
        raise ValueError(f"unknown fault {fault!r}")
