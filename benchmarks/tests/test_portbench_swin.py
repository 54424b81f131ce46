"""The Swin-B configuration's counts and plain trunk (portbench/trunks/
swin_transformer.py): its forward FLOPs by hand, per stage and per patch
merge; the windowed attention cores' least time by hand; and the plain
trunk against the timm oracle of the repository's tests
(tests/_torch_oracles.py) at test-only sizes."""
import json
import sys

import pytest
import torch

from portbench import flops, reference
from portbench.trunks import swin_transformer as S
from tiny import BENCH, ROOT

PEAKS = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
CFG = json.loads((BENCH / "configs" / "swin_b384_fusion_mt.json").read_text())
# Swin-B at 384 px: (resolution, width, depth) of each stage; N = 144
STAGES = ((96, 128, 2), (48, 256, 2), (24, 512, 18), (12, 1024, 2))
N = 144


def _block(L, C):
    return (2 * L * C * 3 * C            # qkv
            + 2 * (2 * L * N * C)        # scores, weighted sum (nW windows)
            + 2 * L * C * C              # proj
            + 2 * 2 * L * C * 4 * C)     # fc1, fc2


def test_swin_b384_forward_flops_by_hand():
    patch = 2 * 96 * 96 * (3 * 4 * 4) * 128
    merges = [2 * res * res * (2 * C) * C for res, C, _ in STAGES[1:]]
    blocks = [d * _block(res * res, C) for res, C, d in STAGES]
    assert merges == [603979776] * 3           # 4 (C/2) -> C, each stage
    assert S.forward_flops(CFG) == patch + sum(merges) + sum(blocks)
    assert round(S.forward_flops(CFG) / 1e9, 2) == 94.16
    heads = 2 * (1024 + 128) * (32 + 18)
    assert flops.forward_flops(CFG) == S.forward_flops(CFG) + heads
    assert 9.03e12 < 32 * flops.train_flops(CFG) < 9.05e12
    attn = sum(d * 2 * (2 * res * res * N * C) for res, C, d in STAGES)
    assert 0.055 < attn / S.forward_flops(CFG) < 0.057   # 5.6%
    assert S.feature_dim(CFG) == 1024


def test_stages_and_window_shapes():
    assert S.stages(CFG) == [(96, 128, 4, 2, 12, 6), (48, 256, 8, 2, 12, 6),
                             (24, 512, 16, 18, 12, 6),
                             (12, 1024, 32, 2, 12, 0)]
    shapes = S.window_core_shapes(CFG, 32)
    assert len(shapes) == 24
    assert shapes[:2] == [(2048, N, 128, 4, 0), (2048, N, 128, 4, 64)]
    assert shapes[4:6] == [(128, N, 512, 16, 0), (128, N, 512, 16, 4)]
    assert shapes[-2:] == [(32, N, 1024, 32, 0)] * 2   # one window, no shift


def test_window_core_least_time_by_hand():
    """Every block's forward and backward core is bound by its bytes at
    Swin-B's shapes (D = 32): the least time is their bytes over the peak."""
    total_bytes = 0
    for res, C, depth in STAGES:
        nw = (res // 12) ** 2
        act = 32 * res * res * C * 2
        heads = C // 32
        for j in range(depth):
            mask = nw if (j % 2 and nw > 1) else 0
            add = heads * N * N * 4 + mask * N * 4
            total_bytes += (4 * act + add) + (7 * act + add
                                              + heads * N * N * 4)
    want = total_bytes / PEAKS["hbm_bytes"]
    assert S.window_core_least_s(CFG, 32, PEAKS) == pytest.approx(
        want, rel=1e-12)
    assert 1.9e-3 < want < 2.0e-3


def test_plain_trunk_matches_the_timm_oracle():
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_oracles import SwinOracle

    cfg = {**CFG, **S.TINY}
    oracle = SwinOracle(img_size=cfg["img_size"], patch_size=4,
                        embed_dim=cfg["embed_dim"], depths=cfg["depths"],
                        num_heads=cfg["num_heads"],
                        window=cfg["window_size"]).double()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in oracle.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64)
                    * 0.3 + (1.0 if p.dim() == 1 else 0.0))
    plain = S.Plain(cfg).double()
    trunk = {k: v for k, v in oracle.state_dict().items()
             if not k.startswith("head.")}
    plain.load_state_dict(trunk, strict=True)
    x = torch.randn(2, 32, 32, 3, generator=g, dtype=torch.float64)
    ours = plain(x, reference.Precision())
    ref = oracle.forward_features(x.permute(0, 3, 1, 2))
    torch.testing.assert_close(ours, ref, rtol=1e-10, atol=1e-12)
    # the fp8 control rounds every product: far from f32, still finite
    ctl = plain.float()(x.float(), reference.Precision("fp8"))
    assert torch.isfinite(ctl).all()
    assert (ctl.double() - ref).norm() / ref.norm() > 1e-3
