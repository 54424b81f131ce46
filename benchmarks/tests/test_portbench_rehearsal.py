"""Each cell rehearsed on the CPU at test-only sizes (tiny.py): the harness's
own set-up, window, reference comparison and result line; then each cell
again with its timed path broken underneath, where `correct` has to come
out false against the cell's own limits."""
import importlib
import json

import numpy as np
import pytest
import torch

from portbench import harness
from tiny import manifest, patch_trunks, tiny_run

CELLS = [w["name"] for w in manifest()["workloads"]]
TRAIN = [c for c in CELLS if not c.endswith(".serve")]


def drive(cell, traced=False, limits=None, seed=7):
    run = tiny_run(cell, seed=seed, traced=traced, limits=limits)
    entry = importlib.import_module(
        f"portbench.entries.{run.workload['entry']}")
    return run, harness.result(run, entry.run(run))


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_result_line(monkeypatch, cell, traced):
    patch_trunks(monkeypatch)
    run, (line, checks) = drive(cell, traced)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert json.loads(json.dumps(line)) == line
    assert line["attempted"] > 0 and line["failed"] == 0
    # whole numbers, as JSON writes them: 32, not 32.0
    assert type(line["attempted"]) is int and type(line["failed"]) is int
    assert line["device"]["platform"] == "cpu"      # never a device metric
    # the compared numbers are the last lines, each beside its limit
    tail = checks[-len(line["checks"]):]
    assert tail and all(c.startswith("check ") and " limit " in c
                        for c in tail)
    numbers = {k: v["value"] for k, v in line["checks"].items()}
    assert all(np.isfinite(v) for v in numbers.values())
    reported = set(line["metrics"])
    if not traced:
        assert "setup_s" in reported and len(reported) >= 2
    else:
        # no device on the CPU: no roofline, MFU or idle share is printed
        assert not any(("roofline" in m or "mfu" in m or "idle" in m)
                       for m in reported)


def _altered_answers(logits):
    """The style logits of every image moved one class on."""
    return [logits[0].roll(1, dims=1), *logits[1:]]


def _break(monkeypatch, fault):
    from artgraph_tpu_torch.cli import _common, predict
    from artgraph_tpu_torch.models import heads
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
        for cls in (heads.NewMultiModalMultiTaskViT,
                    heads.NewMultiModalMultiTask):
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


FAULTS = ([(c, f) for c in TRAIN
           for f in ("state_unchanged", "half_batch", "answer_altered")]
          + [(c, "answer_altered") for c in CELLS if c.endswith(".serve")]
          + [(c, "image_altered") for c in CELLS if c.endswith(".train_jpeg")])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    patch_trunks(monkeypatch)
    _break(monkeypatch, fault)
    run, (line, _) = drive(cell)
    assert line["correct"] is False
    over = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert over, line["checks"]
