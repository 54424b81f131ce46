"""ops/launches.py alone: the launch counter table, keyed by kernel name.

A wrapper counts a launch with `count(name)`; the Trainer snapshots the
table before a CUDA graph capture, restores it after (a capture launches
nothing) and adds the captured step's counts at each replay. Here those
calls run on names alone, with no kernel and no graph.
"""
import collections

import pytest

from artgraph_tpu_torch.ops import launches


@pytest.fixture(autouse=True)
def table(monkeypatch):
    """An empty table for each test."""
    counts = collections.Counter()
    monkeypatch.setattr(launches, "COUNTS", counts)
    return counts


def test_count_adds_under_the_name(table):
    launches.count("fused_block_mlp")
    launches.count("fused_block_mlp")
    launches.count("batchnorm_dx", 3)
    assert table == {"fused_block_mlp": 2, "batchnorm_dx": 3}
    assert launches.COUNTS["csr_segment_sum"] == 0      # never counted
    assert "csr_segment_sum" not in table


def test_snapshot_is_a_copy_and_since_gives_what_moved():
    launches.count("normalize_images")
    before = launches.snapshot()
    launches.count("normalize_images")
    launches.count("conv1x1_bn_stats", 2)
    assert before == {"normalize_images": 1}
    assert launches.since(before) == {"normalize_images": 1,
                                      "conv1x1_bn_stats": 2}
    assert launches.since(launches.snapshot()) == {}


def test_a_capture_restored_then_replayed_counts_each_replay():
    """The Trainer's bookkeeping: an eager step, a capture of the same
    step that restore() takes back, then three replays that add it."""
    step = {"normalize_images": 1, "fused_block_attention": 12,
            "fused_block_mlp_bwd": 12}
    for name, n in step.items():                        # the eager step
        launches.count(name, n)
    before = launches.snapshot()
    for name, n in step.items():                        # the capture
        launches.count(name, n)
    captured = launches.since(before)
    launches.restore(before)
    assert captured == step
    assert launches.snapshot() == before == step
    for _ in range(3):
        launches.add(captured)
    assert launches.snapshot() == {k: 4 * n for k, n in step.items()}


def test_restore_drops_names_first_counted_after_the_snapshot():
    launches.count("fused_attention")
    before = launches.snapshot()
    launches.count("window_attention_core")
    launches.count("fused_attention")
    launches.restore(before)
    assert launches.snapshot() == {"fused_attention": 1}
    assert launches.since(before) == {}
