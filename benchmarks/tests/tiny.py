"""Tiny configurations and workloads for the CPU rehearsal of the cells:
the published files with test-only widths, depths and sizes, and the
port's trunks patched to build at them."""
from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from portbench import harness  # noqa: E402

TINY_VIT = {"img_size": 32, "patch_size": 16, "embed_dim": 128, "depth": 1,
            "num_heads": 2}
TINY_RESNET = {"img_size": 32, "stage_sizes": [1, 1, 1, 1]}
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
    cfg.update(TINY_VIT if cfg["trunk"] == "vit" else TINY_RESNET)
    return cfg


def patch_trunks(monkeypatch) -> None:
    """The port's fusion models build their trunks at the tiny sizes."""
    from artgraph_tpu_torch.models import heads, resnet, vit
    monkeypatch.setattr(heads, "ViT", functools.partial(vit.ViT, **TINY_VIT))
    monkeypatch.setattr(heads, "ResNet50", functools.partial(
        resnet.ResNet50, stage_sizes=tuple(TINY_RESNET["stage_sizes"])))


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
