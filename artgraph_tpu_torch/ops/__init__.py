"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel or raises. The block ops and the conv + BN-statistics
unit are autograd Functions whose backward is a kernel path too, as are
the two attention ops of the unfused paths and the ResNet's BatchNorm chain
(ops/batchnorm.py, reached from models/resnet.py).
"""
from artgraph_tpu_torch.ops.attention import (
    block_attention_bwd_plain, block_attention_plain, fused_attention,
    fused_attention_bwd_plain, fused_attention_plain, fused_block_attention,
    fused_qkv_attention, fused_qkv_attention_bwd_plain,
    fused_qkv_attention_plain)
from artgraph_tpu_torch.ops.conv_bn import (conv1x1_bn_stats,
                                            conv1x1_bn_stats_bwd_plain,
                                            conv1x1_bn_stats_plain)
from artgraph_tpu_torch.ops.mlp import (block_mlp_bwd_plain, block_mlp_plain,
                                        fused_block_mlp)
from artgraph_tpu_torch.ops.preprocess import (normalize_images,
                                               normalize_images_plain)

__all__ = ["block_attention_plain", "block_attention_bwd_plain",
           "fused_block_attention", "fused_attention",
           "fused_attention_plain", "fused_attention_bwd_plain",
           "fused_qkv_attention", "fused_qkv_attention_plain",
           "fused_qkv_attention_bwd_plain", "block_mlp_plain",
           "block_mlp_bwd_plain", "fused_block_mlp", "normalize_images",
           "normalize_images_plain", "conv1x1_bn_stats",
           "conv1x1_bn_stats_plain", "conv1x1_bn_stats_bwd_plain"]
