"""enqueue_ms.serve: the median host time of a call into `infer`, from the
call until it returns with the logits still on the device, in ms (the
benchmark's span "enqueue", every batch of the window)."""
import statistics


def read(view):
    spans = view.run.spans.get("enqueue")
    if not spans:
        return None
    return 1e3 * statistics.median(t1 - t0 for t0, t1 in spans)
