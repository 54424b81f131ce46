"""device_idle_pct.jpeg: the share of the JPEG training cell's (the first window epoch) traced window in
which the device ran no kernel, copy or set, in %: 1 - (the union of
their intervals) / (the window)."""
from portbench import trace


def read(view):
    if not view.work:
        return None
    return 100 * trace.idle_share(view.work, view.t0, view.t1)
