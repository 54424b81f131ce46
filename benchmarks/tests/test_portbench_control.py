"""The control: the plain reference put in the program's place in the
nearest precision below the configuration's (fp8 products in the trunk,
bf16 heads) has to come out not correct against each cell's limits. On
the CPU at the test-only sizes of tiny.py; on a card (marked cuda) at the
cell's own sizes, where the program's own readings have to pass."""
import importlib
import time

import pytest
import torch

from portbench import check, harness
from tiny import manifest, patch_trunks, tiny_run

CELLS = [w["name"] for w in manifest()["workloads"]]


def _calibrate(run):
    entry = importlib.import_module(
        f"portbench.entries.{run.workload['entry']}")
    return entry.calibrate(run)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_cpu(monkeypatch, cell):
    run = tiny_run(cell, seed=11)
    patch_trunks(monkeypatch, run.cfg)
    readings = _calibrate(run)
    limits = run.workload["limits"]
    numbers = {k: v for k, v in readings["control_fp8"].items()
               if k in limits}
    assert numbers and not check.judge(numbers, {k: limits[k]
                                                 for k in numbers})[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run = harness.load_run(cell, 31337, 0.0, False, "cuda:0",
                           time.perf_counter(), manifest())
    readings = _calibrate(run)
    limits = run.workload["limits"]
    assert check.judge({k: readings["program"][k] for k in limits},
                       limits)[0]
    control = {k: v for k, v in readings["control_fp8"].items()
               if k in limits}
    assert not check.judge(control, {k: limits[k] for k in control})[0]
