"""Each cell rehearsed on the CPU at test-only sizes (tiny.py): the harness's
own set-up, window, reference comparison and result line; then each cell
again with its timed path broken underneath, where `correct` has to come
out false against the cell's own limits."""
import json

import numpy as np
import pytest

from tiny import drive, manifest, tiny_run

CELLS = [w["name"] for w in manifest()["workloads"]]
TRAIN = [c for c in CELLS if not c.endswith(".serve")]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_result_line(monkeypatch, cell, traced):
    line, checks = drive(monkeypatch, tiny_run(cell, traced=traced))
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


FAULTS = ([(c, f) for c in TRAIN
           for f in ("state_unchanged", "half_batch", "answer_altered")]
          + [(c, "answer_altered") for c in CELLS if c.endswith(".serve")]
          + [(c, "image_altered") for c in CELLS if c.endswith(".train_jpeg")])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    line, _ = drive(monkeypatch, tiny_run(cell), fault)
    assert line["correct"] is False
    over = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert over, line["checks"]
