"""vit_blocks_roofline.train: the ViT blocks' share of their roofline in a
training step, in %: the least time that the 12 blocks' forward and
backward work needs at the device's peaks (portbench/flops.py
vit_blocks_least_s, recompute not counted) times the steps of the traced
window, over the device time of the kernels named below in it. Left out
when any of the names matches no launch: a kernel was replaced, and the
metric has to be pointed at what replaced it."""
from portbench import flops, trace

KERNELS = (
    r"\bgemm_kernel\b",                  # block_gemm.cu
    r"\blayernorm_rows_kernel\b",        # block_gemm.cu
    r"\battention_core_kernel\b",        # block_attention.cu
    r"\battention_bwd_dq_kernel\b",      # block_attention_bwd.cu
    r"\battention_bwd_dkv_kernel\b",     # block_attention_bwd.cu
    r"\blayernorm_bwd_kernel\b",         # block_norm_bwd.cu
    r"\bcolsum_kernel\b",                # block_norm_bwd.cu
    r"\bsum_groups\w*_kernel\b",         # sum_groups.cuh (split-K, sums)
)


def read(view):
    if not view.work or view.peaks is None:
        return None
    busy, launches = trace.pattern_time(view.work, KERNELS)
    if min(launches.values()) == 0 or busy <= 0:
        return None
    least = flops.vit_blocks_least_s(view.run.cfg, view.run.batch,
                                     view.peaks) * view.steps
    return 100 * least / (busy / 1e6)
