"""ViT-B/16 trunk with timm's state_dict keys, on the port's block kernels.

Port of artgraph_tpu/models/vit.py (`ViT`, kernel path): the patch embedding
runs as a stride-16 conv in `dtype`; the CLS token and the position embedding
are added in f32 and the residual stream is then cast to `dtype`; each of the
`depth` blocks is `fused_block_attention` followed by `fused_block_mlp`; the
final LayerNorm runs in f32 and the CLS token is pooled (timm-0.4
`forward_features`). Parameters are f32. Inputs are normalized NHWC images.
An f64 model (dtype and parameters; the CPU's plain versions only) keeps
f64 where the others keep f32, as the JAX package's at_least_f32 does: the
f64 trajectory tests' path.

`ViT(fuse_qkv=False)` takes the JAX block's unfused branch instead (as the
JAX `ViT(fuse_qkv=False)` does): x + attn(dtype(LN_f32(x))) with the qkv
Linear, `fused_attention` on strided q/k/v views of its output and the proj
Linear, then x + mlp(dtype(LN_f32(x))) with fc1, exact GELU and fc2 in
`dtype`. The Linears, LayerNorms and GELU are plain PyTorch, as the JAX
package leaves them to XLA. The standalone `Attention` module computes
proj(attn(x)) with no LayerNorm and no residual: `fused_qkv_attention` then
proj with `fuse_qkv`, the unfused chain without.

In train() the block ops record their own backward (autograd Functions whose
CUDA backward is a kernel path); the bf16 patch-embed conv, the f32 CLS/pos
add and the final LayerNorm differentiate through torch autograd, as flax
differentiates its bf16 nn.Conv. The trunk has no dropout.

Module and parameter names are timm's (`patch_embed.proj`, `cls_token`,
`pos_embed`, `blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 /
mlp.fc2`, `norm`), so a reference .pt loads with `load_state_dict` and no key
map. Linear weights keep nn.Linear's [out, in] layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from artgraph_tpu_torch.ops import (fused_attention, fused_block_attention,
                                    fused_block_mlp, fused_qkv_attention)
from artgraph_tpu_torch.ops.attention import at_least_f32, cast_weight


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """An f32 nn.Linear applied in x's dtype, as a flax Dense(dtype=...)."""
    return F.linear(x, cast_weight(lin.weight, x.dtype), lin.bias.to(x.dtype))


class Attention(nn.Module):
    """timm's fused qkv and output projections. In a fused block the block
    kernels run them; `forward` is proj(attention(x)) in x's dtype."""

    def __init__(self, dim: int, num_heads: int, fuse_qkv: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.fuse_qkv = fuse_qkv
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        if self.fuse_qkv:
            out = fused_qkv_attention(x, self.qkv.weight, self.qkv.bias,
                                      self.num_heads)
        else:
            qkv = _linear(x, self.qkv).view(B, N, 3, self.num_heads,
                                            C // self.num_heads)
            out = fused_attention(*qkv.unbind(2)).view(B, N, C)
        return _linear(out, self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """fc2(gelu(fc1(x))) in x's dtype, exact (erf) GELU."""
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    """Pre-norm transformer block, residuals included: two fused kernels, or
    (fuse_qkv=False) the unfused branch of the JAX block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 fuse_qkv: bool = True):
        super().__init__()
        self.fuse_qkv = fuse_qkv
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, fuse_qkv)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    @staticmethod
    def _norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        return F.layer_norm(x.to(at_least_f32(x.dtype)), ln.normalized_shape,
                            ln.weight, ln.bias, ln.eps).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fuse_qkv:
            x = x + self.attn(self._norm(x, self.norm1))
            return x + self.mlp(self._norm(x, self.norm2))
        a, m = self.attn, self.mlp
        x = fused_block_attention(x, self.norm1.weight, self.norm1.bias,
                                  a.qkv.weight, a.qkv.bias, a.proj.weight,
                                  a.proj.bias, a.num_heads, self.norm1.eps)
        return fused_block_mlp(x, self.norm2.weight, self.norm2.bias,
                               m.fc1.weight, m.fc1.bias, m.fc2.weight,
                               m.fc2.bias, self.norm2.eps)


class ViT(nn.Module):
    """Vision transformer trunk; NHWC float images in, [B, C] f32 out."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.bfloat16,
                 fuse_qkv: bool = True):
        super().__init__()
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, fuse_qkv)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        proj = self.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype),
                     cast_weight(proj.weight, self.dtype),
                     proj.bias.to(self.dtype),
                     stride=proj.stride)
        x = x.flatten(2).transpose(1, 2)                 # [B, patches, C]
        cls = self.cls_token.expand(B, -1, -1).to(self.dtype)
        x = torch.cat([cls, x], dim=1)
        x = (x.to(at_least_f32(self.dtype)) + self.pos_embed).to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        # LayerNorm is per token, so normalizing only the pooled CLS token
        # gives the CLS row of the normalized sequence
        return F.layer_norm(x[:, 0].to(at_least_f32(self.dtype)),
                            self.norm.normalized_shape, self.norm.weight,
                            self.norm.bias, self.norm.eps)


def vit_base_patch16_224(dtype: torch.dtype = torch.bfloat16) -> ViT:
    """timm's vit_base_patch16_224 trunk (the JAX package's factory)."""
    return ViT(patch_size=16, embed_dim=768, depth=12, num_heads=12,
               mlp_ratio=4.0, dtype=dtype)


def init_random_(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """Fill every parameter from `generator`: LayerNorm weights 1 + N(0, 0.02),
    everything else N(0, 0.02) (timm's init scale, with non-zero biases so the
    bias paths are exercised). For runs without published weights."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=generator) * 0.02
            is_ln_weight = name.endswith("weight") and p.dim() == 1
            p.copy_(noise + 1.0 if is_ln_weight else noise)
    return module
