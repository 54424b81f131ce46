"""step_mfu.serve: the served forward's share of the device's peak bf16
FLOP/s, in %: model FLOPs per image (portbench/flops.py) times the images
served in the traced window, over its seconds and the peak."""
from portbench import flops


def read(view):
    if view.peaks is None or view.seconds <= 0:
        return None
    rate = view.samples / view.seconds
    return 100 * flops.forward_flops(view.run.cfg) * rate \
        / view.peaks["bf16_flops"]
