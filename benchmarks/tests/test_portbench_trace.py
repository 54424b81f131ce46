"""The union, idle and kernel arithmetic on a synthetic chrome trace, and
the rule that a kernel metric is left out when a pattern matches
nothing."""
import json

import pytest

from portbench import harness, trace

MARK = trace.WINDOW_MARK


def ev(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "ph": "X"}


EVENTS = [
    ev("user_annotation", MARK, 100.0, 1000.0),
    ev("cpu_op", "aten::step", 100.0, 200.0),
    ev("cpu_op", "aten::inner", 400.0, 300.0),
    ev("cuda_runtime", "cudaStreamSynchronize", 450.0, 100.0),
    ev("kernel", "void gemm_kernel<1>(x)", 50.0, 150.0),      # clipped 100..200
    ev("kernel", "void unit_gemm_kernel<0, true>(p)", 150.0, 100.0),
    ev("gpu_memcpy", "Memcpy HtoD", 180.0, 120.0),            # other stream
    ev("kernel", "colsum_kernel", 600.0, 50.0),
    ev("gpu_memset", "Memset", 1050.0, 200.0),                # clipped ..1100
    ev("gpu_user_annotation", "Optimizer.step", 100.0, 900.0),
]


def test_union_not_sum_over_overlapping_streams(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    events = trace.load_events(str(path))
    t0, t1 = trace.window(events)
    assert (t0, t1) == (100.0, 1100.0)
    work = trace.device_work(events, t0, t1)
    assert len(work) == 5                     # the annotation is left out
    # union: [100, 300] + [600, 650] + [1050, 1100]
    assert trace.busy(work) == pytest.approx(300.0)
    assert sum(e - s for s, e, _ in work) == pytest.approx(420.0)
    assert trace.idle_share(work, t0, t1) == pytest.approx(0.7)


def test_pattern_time_counts_each_launch_once():
    work = trace.device_work(EVENTS, 100.0, 1100.0)
    t, counts = trace.pattern_time(work, (r"\bgemm_kernel\b",
                                          r"\bunit_gemm_kernel\b"))
    assert counts == {r"\bgemm_kernel\b": 1, r"\bunit_gemm_kernel\b": 1}
    assert t == pytest.approx(100.0 + 100.0)


def test_idle_gaps_named_by_the_innermost_host_span():
    work = trace.device_work(EVENTS, 100.0, 1100.0)
    gaps = dict(trace.idle_gaps(EVENTS, work, 100.0, 1100.0))
    # [300, 600] mid 450: aten::inner (inside it, the runtime call starts
    # at 450 and covers 450); [650, 1050] mid 850: no host span
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-6)
    assert gaps["(no host span)"] == pytest.approx(400e-6)
    ops = dict(trace.top_ops(work))
    assert ops["Memcpy HtoD"] == pytest.approx(120e-6)


class _View:
    peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    steps = 1

    def __init__(self, work, cfg):
        self.work = work
        self.run = type("R", (), {"cfg": cfg, "batch": 32})()


def test_kernel_metric_left_out_when_a_pattern_matches_nothing():
    cfg = harness.load_json(harness.BENCH_DIR / "configs"
                            / "resnet50_fusion_mt.json")
    unit = [(0.0, 5000.0, "void unit_gemm_kernel<0, true>(p)"),
            (5000.0, 6000.0, "void sum_groups_kernel<float>(a)")]
    value = harness.read_metric("conv_bn_roofline.train", _View(unit, cfg))
    assert value is not None and 0 < value < 100
    # the column sums' kernel gone: the metric is left out, not computed
    # from the unit's product alone
    assert harness.read_metric("conv_bn_roofline.train",
                               _View(unit[:1], cfg)) is None
    assert harness.read_metric("vit_blocks_roofline.train",
                               _View(unit, cfg)) is None
