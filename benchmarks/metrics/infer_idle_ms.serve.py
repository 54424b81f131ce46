"""infer_idle_ms.serve: the device's idle time inside the port's
`ag.predict.infer` spans (a serving batch's normalize and forward as
`infer` launches them), summed over the traced window and divided by its
batches, in ms (trace.idle_inside). Left out when the trace has no such
span."""
from portbench import trace

SPAN = "ag.predict.infer"


def read(view):
    return trace.idle_inside(view, SPAN)
