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


def _parent_read(view, span):
    """The two span metrics' read, as each file had it before
    trace.idle_inside."""
    import bisect
    if not view.work:
        return None
    clipped = ((max(float(e["ts"]), view.t0),
                min(float(e["ts"]) + float(e["dur"]), view.t1))
               for e in view.events
               if e.get("name") == span and e.get("cat") == "user_annotation")
    spans = trace.merged((s, e) for s, e in clipped if e > s)
    if not spans:
        return None
    busy = trace.merged(view.work)
    starts = [s for s, _ in busy]
    idle = 0.0
    for s, e in spans:
        idle += e - s
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(busy) and busy[i][0] < e:
            idle -= max(0.0, min(busy[i][1], e) - max(busy[i][0], s))
            i += 1
    return idle / 1e3 / view.steps


def _random_events(span, seed):
    """A 10 ms window with spans (overlapping, and past both of its edges)
    and kernels on two streams, drawn from `seed`."""
    import random
    r = random.Random(seed)
    out = [ev("user_annotation", trace.WINDOW_MARK, 1_000.0, 10_000.0)]
    for _ in range(r.randint(0, 12)):
        out.append(ev(r.choice(("user_annotation", "gpu_user_annotation")),
                      span, r.uniform(0.0, 11_500.0), r.uniform(1.0, 900.0)))
    for k in range(r.randint(0, 40)):
        out.append(ev(r.choice(("kernel", "gpu_memcpy", "gpu_memset")),
                      f"k{k}", r.uniform(0.0, 11_500.0),
                      r.uniform(1.0, 400.0)))
    return out


@pytest.mark.parametrize("metric, span", SPAN_METRICS)
def test_idle_inside_reads_as_the_metrics_read_before(metric, span):
    cases = [events(span, (1_500.0, 2_500.0)), events(span, (8_000.0,
                                                             9_000.0))]
    cases += [_random_events(span, seed) for seed in range(200)]
    read = 0
    for evs in cases:
        v = view(evs, steps=3)
        want = _parent_read(v, span)
        assert trace.idle_inside(v, span) == want
        assert harness.read_metric(metric, v) == want
        read += want is not None
    assert read > 100
