"""The kernels' launch counters, read, restored and added as one.

Each wrapper adds one to its module's counter where it launches its kernel:
the `LAUNCHES*` ints of ops.preprocess, ops.attention, ops.mlp, ops.conv_bn,
ops.batchnorm and ops.csr_segment. A CUDA graph replays its kernels without
running the wrappers, and capturing one launches nothing. So the Trainer takes a
snapshot before a capture, restores it after, and adds the captured step's
counts at each replay: the counters keep counting launches on the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

from artgraph_tpu_torch.ops import attention, batchnorm, conv_bn, \
    csr_segment, mlp, preprocess

COUNTERS = (
    (preprocess, "LAUNCHES"),
    (attention, "LAUNCHES"), (attention, "LAUNCHES_BWD"),
    (attention, "LAUNCHES_ATTENTION"), (attention, "LAUNCHES_ATTENTION_BWD"),
    (attention, "LAUNCHES_QKV"), (attention, "LAUNCHES_QKV_BWD"),
    (attention, "LAUNCHES_WINDOW"), (attention, "LAUNCHES_WINDOW_BWD"),
    (mlp, "LAUNCHES"), (mlp, "LAUNCHES_BWD"),
    (conv_bn, "LAUNCHES"), (conv_bn, "LAUNCHES_BWD"),
    (batchnorm, "LAUNCHES_STATS"), (batchnorm, "LAUNCHES_FINISH"),
    (batchnorm, "LAUNCHES_APPLY"), (batchnorm, "LAUNCHES_COLSUM"),
    (batchnorm, "LAUNCHES_FINISH_BWD"), (batchnorm, "LAUNCHES_DX"),
    (csr_segment, "LAUNCHES_SUM"), (csr_segment, "LAUNCHES_WEIGHTED"),
    (csr_segment, "LAUNCHES_SOFTMAX"), (csr_segment, "LAUNCHES_SCALAR"),
)

Counts = Dict[Tuple[str, str], int]


def snapshot() -> Counts:
    """Every counter, keyed (module name, attribute)."""
    return {(mod.__name__, attr): getattr(mod, attr) for mod, attr in COUNTERS}


def since(before: Counts) -> Counts:
    """What each counter gained since `before` (those that moved)."""
    now = snapshot()
    return {k: now[k] - n for k, n in before.items() if now[k] != n}


def restore(before: Counts) -> None:
    for mod, attr in COUNTERS:
        setattr(mod, attr, before[(mod.__name__, attr)])


def add(counts: Counts) -> None:
    for mod, attr in COUNTERS:
        n = counts.get((mod.__name__, attr))
        if n:
            setattr(mod, attr, getattr(mod, attr) + n)
