"""timm's swin_base_patch4_window12_384 trunk (timm/models/
swin_transformer.py; Liu et al., arXiv:2103.14030): a 4x4 patch embedding
and its LayerNorm, four stages of pre-norm blocks over 12x12 windows, every
second block's windows rolled by half a window under timm's region mask
(-100 between regions), a learned relative-position bias in every block's
scores, patch merging (x0, x1, x2, x3 concatenated, LayerNorm, a bias-free
Linear) before stages 1-3, exact GELU, LayerNorm eps 1e-5, and the mean
over the tokens after the final LayerNorm. Held as `swin` by the port's
NewMultiModalMultiTaskSwin and by the plain model.

The plain model is timm's equations with the roll, window partition and
reverse, the relative-position index and the mask built as timm builds
them, in f32; every product (patch embedding, qkv, scores, weighted sum,
proj, fc1, fc2, reduction) takes the control's rounding through
reference.Precision, as does the residual stream. No stochastic depth (the
configuration's drop_path_rate is 0).

The windowed attention core's work, for window_attention_roofline.train,
is counted here too (`window_core_least_s`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.flops import BF16, F32
from portbench.reference import Precision, conv, linear

PREFIX = "swin"
TINY = {"img_size": 32, "patch_size": 4, "embed_dim": 64, "depths": [2, 2],
        "num_heads": [2, 4], "window_size": 4}
MASKED = -100.0
INT32 = 4


def fusion_class():
    from artgraph_tpu_torch.models import NewMultiModalMultiTaskSwin
    return NewMultiModalMultiTaskSwin


def feature_dim(cfg: dict) -> int:
    return cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)


def init_scale(name: str, shape: tuple, cfg: dict):
    """The relative-position bias tables: std 0.02, as timm draws them."""
    if name.endswith("relative_position_bias_table"):
        return 0.0, 0.02
    return None


def patch_tiny(monkeypatch) -> None:
    from artgraph_tpu_torch.models import heads, swin
    monkeypatch.setattr(heads, "SwinTransformer", functools.partial(
        swin.SwinTransformer, img_size=TINY["img_size"],
        patch_size=TINY["patch_size"], embed_dim=TINY["embed_dim"],
        depths=tuple(TINY["depths"]), num_heads=tuple(TINY["num_heads"]),
        window_size=TINY["window_size"]))


def stages(cfg: dict) -> list:
    """Each stage as (resolution, width, heads, depth, window, shift): a
    stage whose resolution is at most the window takes it whole, unshifted
    (timm)."""
    out = []
    res = cfg["img_size"] // cfg["patch_size"]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        r, w = res // 2 ** i, cfg["window_size"]
        shift = w // 2 if r > w else 0
        out.append((r, cfg["embed_dim"] * 2 ** i, heads, depth, min(r, w),
                    shift))
    return out


def forward_flops(cfg: dict) -> float:
    """Model FLOPs of one image's forward: the patch embedding, the patch
    merges and the blocks (qkv, scores, weighted sum, proj, fc1, fc2)."""
    p = cfg["patch_size"]
    res0 = cfg["img_size"] // p
    total = 2 * res0 * res0 * cfg["in_chans"] * p * p * cfg["embed_dim"]
    for i, (r, c, _, depth, w, _) in enumerate(stages(cfg)):
        L, f = r * r, int(c * cfg["mlp_ratio"])
        if i > 0:
            total += 2 * L * (2 * c) * c       # reduction: 4 (C/2) -> C
        block = (2 * L * c * 3 * c + 2 * (2 * L * w * w * c)
                 + 2 * L * c * c + 2 * 2 * L * c * f)
        total += depth * block
    return total


def window_core_shapes(cfg: dict, batch: int) -> list:
    """(windows, N, C, heads, mask windows or 0) of each block's attention
    core in a step of `batch` images."""
    out = []
    for r, c, heads, depth, w, shift in stages(cfg):
        nw = (r // w) ** 2
        for j in range(depth):
            masked = nw if (j % 2 and shift) else 0
            out.append((batch * nw, w * w, c, heads, masked))
    return out


def window_core_least_s(cfg: dict, batch: int, peaks: dict) -> float:
    """Least seconds of the windowed attention cores' forward and backward
    in one training step of `batch` images. Forward: S = Q K^T and P V,
    4 B N^2 C FLOPs; q, k, v read and o written in bf16, the f32 bias
    [H, N, N] and the int32 shift regions [nW, N] read. Backward (the bias
    gradient included): dP = dO V^T, dV, dQ, dK, 8 B N^2 C FLOPs; q, k, v
    and dO read, dq, dk, dv written in bf16, the bias and regions read and
    dBias written in f32. No recompute."""
    least = lambda fl, by: max(fl / peaks["bf16_flops"],
                               by / peaks["hbm_bytes"])
    total = 0.0
    for bw, n, c, h, nw in window_core_shapes(cfg, batch):
        act = bw * n * c * BF16
        add = h * n * n * F32 + nw * n * INT32
        total += least(4 * bw * n * n * c, 4 * act + add)
        total += least(8 * bw * n * n * c, 7 * act + add + h * n * n * F32)
    return total


# --- the plain trunk ----------------------------------------------------------

def window_partition(x, w):
    """[B, H, W, C] -> [B * nW, w * w, C], windows in raster order."""
    B, H, W, C = x.shape
    x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(windows, w, H, W):
    C = windows.shape[-1]
    x = windows.view(-1, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


def relative_position_index(w: int) -> torch.Tensor:
    """timm's get_relative_position_index for a w x w window."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (w - 1)
    return rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]


def attn_mask(res: int, w: int, shift: int) -> torch.Tensor:
    """timm's mask of the shifted windows: [nW, N, N], -100 between
    regions."""
    img = torch.zeros(1, res, res, 1)
    cnt = 0
    for h in ((0, -w), (-w, -shift), (-shift, None)):
        for v in ((0, -w), (-w, -shift), (-shift, None)):
            img[:, h[0]:h[1], v[0]:v[1], :] = cnt
            cnt += 1
    ids = window_partition(img, w).squeeze(-1)
    diff = ids.unsqueeze(1) - ids.unsqueeze(2)
    return diff.masked_fill(diff != 0, MASKED).masked_fill(diff == 0, 0.0)


class _Attn(nn.Module):
    def __init__(self, d: int, heads: int, w: int):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * w - 1) ** 2, heads))
        self.qkv, self.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)
        self.register_buffer("relative_position_index",
                             relative_position_index(w), persistent=False)


class _Mlp(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, f), nn.Linear(f, d)


class _Block(nn.Module):
    def __init__(self, d: int, heads: int, res: int, w: int, shift: int,
                 f: int, eps: float):
        super().__init__()
        self.heads, self.w, self.shift = heads, w, shift
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attn = _Attn(d, heads, w)
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = _Mlp(d, f)
        self.register_buffer("attn_mask", attn_mask(res, w, shift)
                             if shift else None, persistent=False)


class _Merge(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(4 * d, eps=eps)
        self.reduction = nn.Linear(4 * d, 2 * d, bias=False)


class _Stage(nn.Module):
    def __init__(self, blocks: list, merge: _Merge | None):
        super().__init__()
        if merge is not None:
            self.downsample = merge
        self.blocks = nn.ModuleList(blocks)


class _PatchEmbed(nn.Module):
    def __init__(self, c: int, d: int, patch: int, eps: float):
        super().__init__()
        self.proj = nn.Conv2d(c, d, patch, stride=patch)
        self.norm = nn.LayerNorm(d, eps=eps)


class PlainSwin(nn.Module):
    """timm's Swin trunk: NHWC normalized images in, the mean over the
    final tokens after the final LayerNorm [B, C] out."""

    def __init__(self, cfg: dict):
        super().__init__()
        eps = cfg["norm_eps"]
        self.patch_embed = _PatchEmbed(cfg["in_chans"], cfg["embed_dim"],
                                       cfg["patch_size"], eps)
        self.layers = nn.ModuleList()
        for i, (r, d, heads, depth, w, shift) in enumerate(stages(cfg)):
            f = int(d * cfg["mlp_ratio"])
            blocks = [_Block(d, heads, r, w, shift if j % 2 else 0, f, eps)
                      for j in range(depth)]
            self.layers.append(_Stage(blocks, _Merge(d // 2, eps) if i else
                                      None))
        self.norm = nn.LayerNorm(feature_dim(cfg), eps=eps)

    def forward(self, x, p: Precision):
        x = conv(p, x.permute(0, 3, 1, 2), self.patch_embed.proj)
        x = p.act(self.patch_embed.norm(x.permute(0, 2, 3, 1)))
        for stage in self.layers:
            if hasattr(stage, "downsample"):
                x = p.act(self._merge(stage.downsample, x, p))
            for blk in stage.blocks:
                x = p.act(x + self._attention(blk, blk.norm1(x), p))
                x = p.act(x + linear(p, F.gelu(linear(p, blk.norm2(x),
                                                      blk.mlp.fc1)),
                                     blk.mlp.fc2))
        return self.norm(x).mean((1, 2))

    @staticmethod
    def _merge(m: _Merge, x, p: Precision):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return linear(p, m.norm(x), m.reduction)

    @staticmethod
    def _attention(blk: _Block, y, p: Precision):
        B, H, W, C = y.shape
        s, w, h = blk.shift, blk.w, blk.heads
        if s:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
        win = window_partition(y, w)                       # [B_, N, C]
        B_, N, _ = win.shape
        qkv = linear(p, win, blk.attn.qkv).view(B_, N, 3, h, C // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)               # [B_, h, N, dh]
        a = p.output(p.operand(q) @ p.operand(k).transpose(-1, -2))
        a = a / math.sqrt(C // h)
        table, index = (blk.attn.relative_position_bias_table,
                        blk.attn.relative_position_index)
        a = a + table[index.view(-1)].view(N, N, h).permute(2, 0, 1)
        if blk.attn_mask is not None:
            nw = blk.attn_mask.shape[0]
            a = (a.view(-1, nw, h, N, N)
                 + blk.attn_mask.unsqueeze(1).unsqueeze(0)).view(-1, h, N, N)
        o = p.output(p.operand(torch.softmax(a, -1)) @ p.operand(v))
        o = linear(p, o.transpose(1, 2).reshape(B_, N, C), blk.attn.proj)
        y = window_reverse(o, w, H, W)
        return torch.roll(y, shifts=(s, s), dims=(1, 2)) if s else y


Plain = PlainSwin
