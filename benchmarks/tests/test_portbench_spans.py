"""The metrics that read the port's spans and counter, over synthetic
chrome-trace events: the device's idle time inside the spans per step, the
gpu_user_annotation twins left out, and nothing read where the program has
no such span or counter (the parent of the commit that added them)."""
import pytest

from portbench import harness, trace

SPAN_METRICS = [("replay_idle_ms.train", "ag.trainer.replay"),
                ("infer_idle_ms.serve", "ag.predict.infer")]


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
            "ph": "X"}


def view(events, steps=2):
    t0, t1 = trace.window(events)
    return harness.View(None, None, 0.0, 0.0, steps, (0.0, 1.0), events,
                        trace.device_work(events, t0, t1), t0, t1)


def events(span, gap):
    """A 10 ms window, two spans of 2 ms, the device busy but for `gap`
    (trace microseconds)."""
    out = [ev("user_annotation", trace.WINDOW_MARK, 0.0, 10_000.0)]
    for ts in (1_000.0, 5_000.0):
        out.append(ev("user_annotation", span, ts, 2_000.0))
    # the spans' device-side twins, one of them over the gap outside them
    out.append(ev("gpu_user_annotation", span, 8_000.0, 1_000.0))
    out.append(ev("kernel", "k0", 0.0, gap[0]))
    out.append(ev("kernel", "k1", gap[1], 10_000.0 - gap[1]))
    return out


@pytest.mark.parametrize("metric, span", SPAN_METRICS)
def test_idle_inside_the_spans_per_step(metric, span):
    inside = view(events(span, (1_500.0, 2_500.0)))
    assert harness.read_metric(metric, inside) == pytest.approx(0.5)
    outside = view(events(span, (8_000.0, 9_000.0)))
    assert harness.read_metric(metric, outside) == pytest.approx(0.0)
    # at most the window's idle time, over its steps
    for v in (inside, outside):
        idle_ms = trace.idle_share(v.work, v.t0, v.t1) * 10.0
        assert harness.read_metric(metric, v) * v.steps <= idle_ms + 1e-9


@pytest.mark.parametrize("metric, span", SPAN_METRICS)
def test_span_metric_without_its_span(metric, span):
    host_only = [e for e in events(span, (1_500.0, 2_500.0))
                 if not (e["name"] == span and e["cat"] == "user_annotation")]
    assert harness.read_metric(metric, view(host_only)) is None


def test_weight_cast_mb_reads_the_counter(monkeypatch):
    from artgraph_tpu_torch import profiling
    v = view(events("ag.predict.infer", (1_500.0, 2_500.0)))
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"weight_cast_bytes": 2 * 171_048_960})
    assert harness.read_metric("weight_cast_mb.serve", v) == \
        pytest.approx(171.04896)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert harness.read_metric("weight_cast_mb.serve", v) is None
    monkeypatch.delattr(profiling, "counters")
    assert harness.read_metric("weight_cast_mb.serve", v) is None
