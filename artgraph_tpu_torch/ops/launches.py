"""The kernels' launch counters: one table, keyed by kernel name.

Each wrapper calls `count(name)` where it launches its kernel, one count a
call however many kernels it runs: normalize_images,
fused_block_attention[_bwd], window_attention_core[_bwd] (the block's calls
that take the windowed cores), fused_block_mlp[_bwd], fused_attention[_bwd],
fused_qkv_attention[_bwd], conv1x1_bn_stats[_bwd], csr_segment_sum,
csr_weighted_segment_sum, csr_attention_aggregate, csr_scalar_segment_sum
and batchnorm_{stats,finish,apply,colsum,finish_bwd,dx}. A name no call has
counted reads 0.

A CUDA graph replays its kernels without running the wrappers, and capturing
one launches nothing. So the Trainer takes a snapshot before a capture,
restores it after, and adds the captured step's counts at each replay: the
table keeps counting launches on the card. This module imports no op module.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

Counts = Dict[str, int]

COUNTS: Counter = Counter()


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n


def snapshot() -> Counts:
    """Every counter, keyed by name."""
    return dict(COUNTS)


def since(before: Counts) -> Counts:
    """What each counter gained since `before` (those that moved)."""
    return {k: COUNTS[k] - before.get(k, 0)
            for k in dict.fromkeys([*before, *COUNTS])
            if COUNTS[k] != before.get(k, 0)}


def restore(before: Counts) -> None:
    COUNTS.clear()
    COUNTS.update(before)


def add(counts: Counts) -> None:
    COUNTS.update(counts)
