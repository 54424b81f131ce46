"""timm's vit_base_patch16_224 trunk (pre-norm blocks, exact GELU,
LayerNorm eps 1e-6, the normed CLS token pooled), held as `vit` by the
port's NewMultiModalMultiTaskViT and by the plain model."""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.flops import vit_forward_flops as forward_flops  # noqa: F401
from portbench.reference import Precision, conv, linear

PREFIX = "vit"
TINY = {"img_size": 32, "patch_size": 16, "embed_dim": 128, "depth": 1,
        "num_heads": 2}


def fusion_class():
    from artgraph_tpu_torch.models import NewMultiModalMultiTaskViT
    return NewMultiModalMultiTaskViT


def feature_dim(cfg: dict) -> int:
    return cfg["embed_dim"]


def init_scale(name: str, shape: tuple, cfg: dict):
    """The class token and position embedding: std 0.02."""
    if name.endswith(("cls_token", "pos_embed")):
        return 0.0, 0.02
    return None


def patch_tiny(monkeypatch) -> None:
    from artgraph_tpu_torch.models import heads, vit
    monkeypatch.setattr(heads, "ViT", functools.partial(vit.ViT, **TINY))


class _Attn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv, self.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, f), nn.Linear(f, d)


class _Block(nn.Module):
    def __init__(self, d: int, f: int, eps: float):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=eps), nn.LayerNorm(
            d, eps=eps)
        self.attn, self.mlp = _Attn(d), _Mlp(d, f)


class _PatchEmbed(nn.Module):
    def __init__(self, c: int, d: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(c, d, patch, stride=patch)


class PlainViT(nn.Module):
    """timm's vit_base_patch16_224 trunk: NHWC normalized images in, the
    normed CLS token [B, D] out."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, self.heads = cfg["embed_dim"], cfg["num_heads"]
        n = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
        self.patch_embed = _PatchEmbed(cfg["in_chans"], d, cfg["patch_size"])
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, d))
        self.blocks = nn.ModuleList(
            _Block(d, int(d * cfg["mlp_ratio"]), cfg["norm_eps"])
            for _ in range(cfg["depth"]))
        self.norm = nn.LayerNorm(d, eps=cfg["norm_eps"])

    def forward(self, x, p: Precision):
        x = conv(p, x.permute(0, 3, 1, 2), self.patch_embed.proj)
        x = x.flatten(2).transpose(1, 2)
        B, _, d = x.shape
        x = p.act(torch.cat([self.cls_token.expand(B, -1, -1), x], 1)
                  + self.pos_embed)
        for blk in self.blocks:
            x = p.act(x + self._attention(blk, blk.norm1(x), p))
            x = p.act(x + linear(p, F.gelu(linear(p, blk.norm2(x),
                                                  blk.mlp.fc1)),
                                 blk.mlp.fc2))
        return self.norm(x[:, 0])

    def _attention(self, blk: _Block, y, p: Precision):
        B, N, d = y.shape
        h = self.heads
        qkv = linear(p, y, blk.attn.qkv).view(B, N, 3, h, d // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # [B, h, N, dh]
        s = p.output(p.operand(q) @ p.operand(k).transpose(-1, -2))
        a = torch.softmax(s / math.sqrt(d // h), dim=-1)
        o = p.output(p.operand(a) @ p.operand(v))
        return linear(p, o.transpose(1, 2).reshape(B, N, d), blk.attn.proj)


Plain = PlainViT
