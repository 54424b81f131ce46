"""infer_idle_ms.serve: the device's idle time inside the port's
`ag.predict.infer` spans (a serving batch's normalize and forward as
`infer` launches them), summed over the traced window and divided by its
batches, in ms. Spans are the host events of cat user_annotation (their
gpu_user_annotation twins are left out); idle is the complement, in the
window, of the union of the device's kernels, copies and sets. Left out
when the trace has no such span."""
import bisect

from portbench import trace

SPAN = "ag.predict.infer"


def read(view):
    if not view.work:
        return None
    clipped = ((max(float(ev["ts"]), view.t0),
                min(float(ev["ts"]) + float(ev["dur"]), view.t1))
               for ev in view.events
               if ev.get("name") == SPAN and ev.get("cat") == "user_annotation")
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
