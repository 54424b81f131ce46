"""window_attention_roofline.train: the windowed attention cores' share of
their roofline in a Swin training step, in %: the least time of the cores'
forward and backward work (the bias gradient included) at the device's
peaks, from the configuration's shapes (portbench/trunks/swin_transformer.py
window_core_least_s), times the steps of the traced window, over the device
time of the kernels named below in it. The dBias runs' fixed-order sum runs
in sum_groups.cuh's kernels, which the GEMMs share, so its time is not
counted. Left out when any of the names matches no launch."""
from portbench import trace
from portbench.trunks import swin_transformer

KERNELS = (
    r"\bwindow_attention_kernel\b",      # block_attention.cu
    r"\bwindow_bwd_dq_kernel\b",         # block_attention_bwd.cu, phases 1, 3
    r"\bwindow_bwd_dkv_kernel\b",        # block_attention_bwd.cu, phase 2
)


def read(view):
    if not view.work or view.peaks is None:
        return None
    busy, launches = trace.pattern_time(view.work, KERNELS)
    if min(launches.values()) == 0 or busy <= 0:
        return None
    least = swin_transformer.window_core_least_s(
        view.run.cfg, view.run.batch, view.peaks) * view.steps
    return 100 * least / (busy / 1e6)
