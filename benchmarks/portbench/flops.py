"""Operations and bytes of the models' work, counted from a configuration's
shapes.

Model FLOPs count the multiply-adds of every matrix product and convolution
(2 per multiply-add) and nothing else; training counts three times the
forward (the forward, and the input and weight gradients), with no
recompute. A kernel group's least time is the sum, over its operations, of
the larger of operations / peak FLOP/s and bytes / peak bytes/s, where an
operation's bytes read each of its inputs once and write each of its
outputs once, whatever kernels implement it.
"""
from __future__ import annotations

from portbench import trunks

BF16, F32 = 2, 4


def _vit_tokens(cfg: dict) -> tuple[int, int]:
    patches = (cfg["img_size"] // cfg["patch_size"]) ** 2
    return patches, patches + 1


def vit_block_flops(cfg: dict) -> dict:
    """Forward FLOPs of one ViT block per image: {'attn': the attention
    sub-block (qkv, scores, weighted sum, proj), 'mlp': fc1 and fc2}."""
    _, n = _vit_tokens(cfg)
    d = cfg["embed_dim"]
    f = int(d * cfg["mlp_ratio"])
    attn = 2 * n * d * 3 * d + 2 * (2 * n * n * d) + 2 * n * d * d
    mlp = 2 * n * d * f + 2 * n * f * d
    return {"attn": attn, "mlp": mlp}


def vit_forward_flops(cfg: dict) -> float:
    """Forward FLOPs of the ViT trunk per image: the patch embedding and
    the blocks (LayerNorms, softmax and GELU not counted)."""
    patches, _ = _vit_tokens(cfg)
    d = cfg["embed_dim"]
    patch = 2 * patches * (cfg["in_chans"] * cfg["patch_size"] ** 2) * d
    blk = vit_block_flops(cfg)
    return patch + cfg["depth"] * (blk["attn"] + blk["mlp"])


def resnet_convs(cfg: dict, img: int | None = None) -> list:
    """Every convolution of the ResNet trunk (torchvision v1.5: the stride on
    the 3x3) as (cin, cout, k, out_h, out_w, kind), kind one of 'stem',
    'conv1', 'conv2', 'conv3', 'down'."""
    h = img or cfg["img_size"]
    h = (h + 2 * 3 - 7) // 2 + 1                       # conv1, stride 2
    convs = [(3, cfg["widths"][0], 7, h, h, "stem")]
    h = (h + 2 * 1 - 3) // 2 + 1                       # max-pool, stride 2
    inplanes = cfg["widths"][0]
    e = cfg["expansion"]
    for stage, (blocks, width) in enumerate(zip(cfg["stage_sizes"],
                                                cfg["widths"])):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            ho = (h + 2 - 3) // stride + 1
            convs.append((inplanes, width, 1, h, h, "conv1"))
            convs.append((width, width, 3, ho, ho, "conv2"))
            convs.append((width, width * e, 1, ho, ho, "conv3"))
            if b == 0:
                convs.append((inplanes, width * e, 1, ho, ho, "down"))
            inplanes, h = width * e, ho
    return convs


def resnet_forward_flops(cfg: dict) -> float:
    """Forward FLOPs of the ResNet trunk per image (convolutions only)."""
    return sum(2 * cin * cout * k * k * h * w
               for cin, cout, k, h, w, _ in resnet_convs(cfg))


def trunk_dim(cfg: dict) -> int:
    return trunks.get(cfg).feature_dim(cfg)


def heads_forward_flops(cfg: dict) -> float:
    """The fusion heads' Linear layers per image."""
    return 2 * (trunk_dim(cfg) + cfg["emb_size"]) * sum(
        cfg["num_classes"].values())


def forward_flops(cfg: dict) -> float:
    """Model FLOPs of one image's forward: trunk and heads."""
    return trunks.get(cfg).forward_flops(cfg) + heads_forward_flops(cfg)


def train_flops(cfg: dict) -> float:
    """Model FLOPs of one image's training step: three forwards."""
    return 3 * forward_flops(cfg)


def _least(flops: float, nbytes: float, peaks: dict) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"])


def vit_blocks_least_s(cfg: dict, batch: int, peaks: dict) -> float:
    """Least seconds of the ViT blocks' forward and backward in one training
    step of `batch` images. Per block: the attention sub-block and the MLP
    sub-block, each forward (FLOPs above) and backward (twice those); bytes:
    the bf16 activation in and out (and the cotangents in the backward), the
    f32 parameters read (and their f32 gradients written)."""
    _, n = _vit_tokens(cfg)
    d = cfg["embed_dim"]
    f = int(d * cfg["mlp_ratio"])
    blk = vit_block_flops(cfg)
    act = batch * n * d * BF16
    params = {"attn": (3 * d * d + 3 * d + d * d + d + 2 * d) * F32,
              "mlp": (d * f + f + f * d + d + 2 * d) * F32}
    total = 0.0
    for part in ("attn", "mlp"):
        fl = batch * blk[part]
        total += _least(fl, 2 * act + params[part], peaks)             # fwd
        total += _least(2 * fl, 3 * act + 2 * params[part], peaks)     # bwd
    return cfg["depth"] * total


def conv_bn_unit_shapes(cfg: dict, batch: int) -> list:
    """(M, K, N, prologue) of each launch of the fused 1x1-conv +
    BN-statistics unit in a training forward: every bottleneck's conv1
    (no prologue) and conv3 (with the bn2 apply + ReLU prologue)."""
    out = []
    for cin, cout, k, h, w, kind in resnet_convs(cfg):
        if kind == "conv1":
            out.append((batch * h * w, cin, cout, False))
        elif kind == "conv3":
            out.append((batch * h * w, cin, cout, True))
    return out


def conv_bn_least_s(cfg: dict, batch: int, peaks: dict) -> float:
    """Least seconds of the unit's forward and backward launches in one
    training step. Forward: x [M, K] bf16, the f32 weight [N, K], the
    prologue's a and b, y [M, N] bf16 and the two f32 column sums out;
    2MKN FLOPs. Backward: x, w, y, dy and the column sums' cotangents (and
    a, b) in; dx, the f32 dW (and da, db) out; 4MKN FLOPs."""
    total = 0.0
    for m, k, n, prologue in conv_bn_unit_shapes(cfg, batch):
        ab = 2 * k * BF16 if prologue else 0
        fwd_bytes = m * k * BF16 + n * k * F32 + ab + m * n * BF16 \
            + 2 * n * F32
        bwd_bytes = (m * k * BF16 + n * k * F32 + ab + 2 * m * n * BF16
                     + 2 * n * F32 + m * k * BF16 + n * k * F32
                     + ab)
        total += _least(2 * m * k * n, fwd_bytes, peaks)
        total += _least(4 * m * k * n, bwd_bytes, peaks)
    return total
