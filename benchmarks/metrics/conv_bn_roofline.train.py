"""conv_bn_roofline.train: the fused 1x1-conv + BN-statistics unit's share
of its roofline in a training step, in %: the least time of the unit's
forward and backward launches at the device's peaks, from their 1x1-conv
shapes (portbench/flops.py conv_bn_least_s), times the steps of the traced
window, over the device time of the kernels named below in it. Left out
when any of the names matches no launch."""
from portbench import flops, trace

KERNELS = (
    r"\bunit_gemm_kernel\b",             # conv_bn.cu, every mode
    r"\bsum_groups\w*_kernel\b",         # sum_groups.cuh (column sums)
)


def read(view):
    if not view.work or view.peaks is None:
        return None
    busy, launches = trace.pattern_time(view.work, KERNELS)
    if min(launches.values()) == 0 or busy <= 0:
        return None
    least = flops.conv_bn_least_s(view.run.cfg, view.run.batch,
                                  view.peaks) * view.steps
    return 100 * least / (busy / 1e6)
