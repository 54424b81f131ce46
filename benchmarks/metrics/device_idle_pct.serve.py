"""device_idle_pct.serve: the share of the serving cell's (the first traced batches) traced window in
which the device ran no kernel, copy or set, in %: 1 - (the union of
their intervals) / (the window)."""
from portbench import trace


def read(view):
    if not view.work:
        return None
    return 100 * trace.idle_share(view.work, view.t0, view.t1)
