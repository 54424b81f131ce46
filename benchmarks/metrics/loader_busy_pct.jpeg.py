"""loader_busy_pct.jpeg: the share of the measured window that the
Trainer's producer thread spent waiting in `next()` on the host loader for
a decoded batch, in % (the benchmark's span "loader_next")."""


def read(view):
    spans = view.run.spans.get("loader_next")
    if not spans:
        return None
    w0, w1 = view.window
    waited = sum(max(0.0, min(t1, w1) - max(t0, w0)) for t0, t1 in spans)
    return 100 * waited / (w1 - w0)
