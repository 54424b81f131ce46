"""The FLOP and byte counts against hand counts of both configurations."""
import json

import pytest

from portbench import flops
from tiny import BENCH

PEAKS = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_vit_b16_forward_flops_by_hand():
    c = cfg("vit_b16_fusion_mt")
    n, d, f = 197, 768, 3072
    block = (2 * n * d * 3 * d          # qkv
             + 2 * n * n * d * 2        # scores and the weighted sum
             + 2 * n * d * d            # proj
             + 2 * 2 * n * d * f)       # fc1, fc2
    patch = 2 * 196 * (3 * 16 * 16) * d
    heads = 2 * (768 + 128) * (32 + 18)
    assert flops.forward_flops(c) == patch + 12 * block + heads
    assert 35.0e9 < flops.forward_flops(c) < 35.3e9    # ~35.1 GFLOP
    assert flops.train_flops(c) == 3 * flops.forward_flops(c)


def test_resnet50_forward_flops_by_hand():
    c = cfg("resnet50_fusion_mt")
    convs = flops.resnet_convs(c)
    assert len(convs) == 1 + 16 * 3 + 4            # stem, 3 a block, 4 down
    assert convs[0] == (3, 64, 7, 112, 112, "stem")
    # stage 2's first block: conv1 at 56x56, the stride on the 3x3
    s2 = [cv for cv in convs if cv[1] == 128 and cv[5] == "conv1"][0]
    assert s2 == (256, 128, 1, 56, 56, "conv1")
    assert [cv for cv in convs if cv[5] == "conv2" and cv[0] == 128][0][3] \
        == 28
    # torchvision's ResNet50: 4.09 GMACs with its 2048x1000 fc, which the
    # fusion trunk does not have
    macs = flops.resnet_forward_flops(c) / 2
    assert abs(macs + 2048 * 1000 - 4.089e9) < 0.01e9
    assert flops.trunk_dim(c) == 2048


def test_vit_blocks_least_time_is_the_flop_bound():
    c = cfg("vit_b16_fusion_mt")
    per_image = 12 * sum(flops.vit_block_flops(c).values())
    # every block operation is bound by FLOPs at batch 32: 3x forward
    assert flops.vit_blocks_least_s(c, 32, PEAKS) == pytest.approx(
        3 * 32 * per_image / 989e12, rel=1e-12)
    assert 3.3e-3 < flops.vit_blocks_least_s(c, 32, PEAKS) < 3.45e-3


def test_conv_bn_unit_shapes_and_bytes():
    c = cfg("resnet50_fusion_mt")
    shapes = flops.conv_bn_unit_shapes(c, 32)
    assert len(shapes) == 32                       # 16 conv1 + 16 conv3
    assert shapes[0] == (32 * 56 * 56, 64, 64, False)
    assert shapes[1] == (32 * 56 * 56, 64, 256, True)
    assert shapes[-1] == (32 * 7 * 7, 512, 2048, True)
    m, k, n = 32 * 56 * 56, 64, 64
    fwd_bytes = m * k * 2 + n * k * 4 + m * n * 2 + 2 * n * 4
    assert flops._least(2 * m * k * n, fwd_bytes, PEAKS) == \
        fwd_bytes / 3.35e12                        # a byte-bound launch
    total = flops.conv_bn_least_s(c, 32, PEAKS)
    assert 0.3e-3 < total < 2e-3
