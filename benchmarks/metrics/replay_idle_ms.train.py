"""replay_idle_ms.train: the device's idle time inside the port's
`ag.trainer.replay` spans (a training step's copies into its graph's
inputs, the graph's launch and the launch counters' update), summed over
the traced window and divided by its steps, in ms (trace.idle_inside).
Left out when the trace has no such span."""
from portbench import trace

SPAN = "ag.trainer.replay"


def read(view):
    return trace.idle_inside(view, SPAN)
