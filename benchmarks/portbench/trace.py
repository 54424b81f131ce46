"""Device time from a torch.profiler chrome trace.

The parsing follows the port's `chip_smoke.py` (`_device_work`, phase 23):
the device's work is the trace's events of the categories in DEVICE_WORK;
the "gpu_user_annotation" spans cover kernels that are counted on their own
and are left out. Unlike that script, busy time is the UNION of the work's
intervals, not their sum (two streams that overlap, such as the host
loader's copy stream beside the step's, count once), and the idle share is
taken over the traced window itself, the host span named WINDOW_MARK.
Times in a chrome trace are microseconds.
"""
from __future__ import annotations

import bisect
import json
import re
from typing import Iterable

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_MARK = "portbench.window"
# host spans looked at, back from a gap's middle, to find the one covering it
_GAP_SCAN = 4000


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def window(events: list, mark: str = WINDOW_MARK) -> tuple[float, float]:
    """(start, end) of the host span `mark`, in trace microseconds."""
    spans = [ev for ev in events if ev.get("name") == mark
             and ev.get("cat") in HOST_CATS]
    if len(spans) != 1:
        raise ValueError(f"expected one {mark!r} span in the trace, found "
                         f"{len(spans)}")
    ev = spans[0]
    return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])


def device_work(events: list, t0: float, t1: float) -> list:
    """[(start, end, name)] of the device's work, clipped to [t0, t1]."""
    out = []
    for ev in events:
        if ev.get("cat") not in DEVICE_WORK:
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        s, e = max(s, t0), min(e, t1)
        if e > s:
            out.append((s, e, ev["name"]))
    return out


def merged(intervals: Iterable) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint
    [start, end] pairs."""
    out: list = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(intervals: Iterable) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in merged(intervals))


def idle_share(intervals: list, t0: float, t1: float) -> float:
    """1 - busy / window: the share of [t0, t1] in which the device ran
    nothing."""
    return 1.0 - busy(intervals) / (t1 - t0)


def idle_inside(view, span: str) -> float | None:
    """The device's idle time inside the host spans named `span` (cat
    user_annotation; their gpu_user_annotation twins are left out) in the
    traced part of `view` (a harness.View), summed and divided by its
    steps, in ms. Idle is the complement of the union of the device's work.
    None when the trace has no device work or no such span."""
    if not view.work:
        return None
    clipped = ((max(float(ev["ts"]), view.t0),
                min(float(ev["ts"]) + float(ev["dur"]), view.t1))
               for ev in view.events
               if ev.get("name") == span
               and ev.get("cat") == "user_annotation")
    spans = merged((s, e) for s, e in clipped if e > s)
    if not spans:
        return None
    work = merged(view.work)
    starts = [s for s, _ in work]
    idle = 0.0
    for s, e in spans:
        idle += e - s
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(work) and work[i][0] < e:
            idle -= max(0.0, min(work[i][1], e) - max(work[i][0], s))
            i += 1
    return idle / 1e3 / view.steps


def pattern_time(intervals: list, patterns: Iterable[str]
                 ) -> tuple[float, dict]:
    """(summed duration of the work whose name matches any pattern, {pattern:
    launches}). A pattern is a regular expression searched in the kernel's
    name; each launch counts under the first pattern it matches."""
    compiled = [(p, re.compile(p)) for p in patterns]
    counts = {p: 0 for p, _ in compiled}
    total = 0.0
    for s, e, name in intervals:
        for p, rx in compiled:
            if rx.search(name):
                counts[p] += 1
                total += e - s
                break
    return total, counts


def top_ops(intervals: list, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations with the most summed
    time."""
    sums: dict = {}
    for s, e, name in intervals:
        sums[name] = sums.get(name, 0.0) + (e - s)
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us / 1e6] for name, us in ranked]


def idle_gaps(events: list, intervals: list, t0: float, t1: float,
              n: int = 10) -> list:
    """[[host activity, seconds]]: the device's idle gaps inside [t0, t1],
    each named by the innermost host span (operator, annotation or runtime
    call, on any thread) that covers the gap's middle, summed by name; the n
    largest sums."""
    hosts = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                    ev["name"]) for ev in events
                   if ev.get("cat") in HOST_CATS and "dur" in ev
                   and ev.get("name") != WINDOW_MARK)
    starts = [h[0] for h in hosts]
    gaps, cursor = [], t0
    for s, e in merged(intervals) + [[t1, t1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    sums: dict = {}
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        inner = None
        # the latest-starting span that covers mid is the innermost one
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 1
                           - _GAP_SCAN), -1):
            if hosts[i][1] >= mid:
                inner = hosts[i][2]
                break
        key = inner or "(no host span)"
        sums[key] = sums.get(key, 0.0) + (ge - gs)
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us / 1e6] for name, us in ranked]
