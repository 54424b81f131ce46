"""Swin Transformer trunk (timm's swin_base_patch4_window12_384 by default)
with timm's state_dict keys, on the port's block kernels.

timm's equations (github.com/huggingface/pytorch-image-models,
timm/models/swin_transformer.py; Liu et al., arXiv:2103.14030): a 4x4
stride-4 patch embedding and its LayerNorm; four stages of pre-norm blocks
over 12x12 windows of N = 144 tokens, every second block's windows shifted
cyclically by half a window under timm's region mask (-100 between
regions), each block's scores carrying a learned relative-position bias
(a [(2w-1)^2, H] table indexed into [H, N, N]); patch merging between stages
(the 2x2 neighbours concatenated in timm's x0, x1, x2, x3 order, LayerNorm
over 4C, a bias-free Linear to 2C); the final LayerNorm, then the mean over
the tokens. A stage whose resolution is at most the window takes the whole
map as one window and no shift, as timm does.

Layout. LayerNorm, the MLP and the residual act on each token alone, so a
stage's residual stream stays in window order, [B * nW, N, C] rows, and
moves between the regular and the shifted windows by one row gather (the
composition of timm's roll and partition and their inverses), then back to
raster order at the stage's end for patch merging. Each gather is an
autograd Function whose backward is the inverse gather: no atomics. Each
block is `fused_block_attention` on the windows with its gathered bias and,
when shifted, each token's region id (`attn_regions`, from which the op
builds timm's mask), then `fused_block_mlp`, both with eps 1e-5.

Dtypes as the port's ViT: parameters f32, the residual stream in `dtype`
(bf16), LayerNorm statistics in f32 (the kernels', and F.layer_norm on f32
copies for the patch embedding, patch merging and the final norm), the
patch embedding and merging products in `dtype`, the feature f32. There is
no stochastic depth (timm's class default drop_path_rate 0.1; the port's
ViT has none either) and no dropout.

Names are timm's: `patch_embed.proj`, `patch_embed.norm`,
`layers.{i}.downsample.{norm,reduction}` (stages 1-3, at the stage's start),
`layers.{i}.blocks.{j}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}`, `norm`; the
buffers `attn.relative_position_index` and `attn_mask` (kept as timm
has it) are not persistent, as in timm, nor are the port's own
(`attn_regions`, the gathers' and the bias gradient's indices), so a timm
state_dict loads with `load_state_dict` and no key map.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from artgraph_tpu_torch.models.vit import Mlp
from artgraph_tpu_torch.ops import fused_block_attention, fused_block_mlp
from artgraph_tpu_torch.ops.attention import region_mask
from artgraph_tpu_torch.ops.block_gemm import at_least_f32, cast_weight


def relative_position_index(window: int) -> torch.Tensor:
    """[N, N] int64: the table row of each (query, key) pair of a window,
    timm's get_relative_position_index."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def window_order(res: int, window: int, shift: int) -> torch.Tensor:
    """[res * res] int64: the raster index of each row of the window layout
    (windows in raster order, tokens in raster order within a window) of
    the map rolled by -shift on both axes, as timm's roll then partition."""
    n = res // window
    wh, ww, th, tw = torch.meshgrid(*(torch.arange(k) for k in
                                      (n, n, window, window)), indexing="ij")
    r = (wh * window + th + shift) % res
    c = (ww * window + tw + shift) % res
    return (r * res + c).flatten()


def shift_regions(res: int, window: int, shift: int) -> torch.Tensor:
    """[nW, N] int32: timm's region id of each token of each window of the
    rolled map (the 3 x 3 regions that the roll by -shift brings together),
    which fused_block_attention turns into the shift mask."""
    img = torch.zeros(res, res, dtype=torch.int32)
    cnt = 0
    cuts = ((0, -window), (-window, -shift), (-shift, None))
    for h in cuts:
        for w in cuts:
            img[h[0]:h[1], w[0]:w[1]] = cnt
            cnt += 1
    return img.flatten()[window_order(res, window, 0)].view(-1, window ** 2)


def shift_mask(res: int, window: int, shift: int) -> torch.Tensor:
    """[nW, N, N] f32: timm's attention mask of the shifted windows, 0
    within a region and -100 between regions."""
    return region_mask(shift_regions(res, window, shift))


def merge_order(x: torch.Tensor, res: int) -> torch.Tensor:
    """[B, res^2, C] raster -> [B, res^2 / 4, 4C]: each 2x2 neighbourhood's
    tokens concatenated as timm's x0 (even row, even column), x1 (odd, even),
    x2 (even, odd), x3 (odd, odd)."""
    B, _, C = x.shape
    x = x.reshape(B, res // 2, 2, res // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    return x.reshape(B, (res // 2) ** 2, 4 * C)


class _Gather(torch.autograd.Function):
    """x [B, L, C] -> x[:, idx]; the backward is the inverse gather."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return x.index_select(1, idx)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g.index_select(1, inv), None, None


class _BiasGather(torch.autograd.Function):
    """table [T, H] -> the bias [H, N, N] (timm's table[index] permuted).
    The backward adds each table row's N * N / T entries of dBias by a
    gather over `sources` [T, K] (flat (query, key) positions, padded with
    N * N, a zero row) and a sum: a fixed order, no atomics."""

    @staticmethod
    def forward(ctx, table, index, sources):
        ctx.save_for_backward(sources)
        N = index.shape[0]
        return table.index_select(0, index.flatten()).view(N, N, -1) \
            .permute(2, 0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        sources, = ctx.saved_tensors
        H = g.shape[0]
        flat = g.permute(1, 2, 0).reshape(-1, H)
        flat = torch.cat([flat, flat.new_zeros(1, H)])
        return flat[sources].sum(1), None, None


def bias_sources(index: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, K] int64: for each table row, the flat positions of `index`
    that read it, padded with index.numel()."""
    flat = index.flatten()
    counts = torch.bincount(flat, minlength=rows)
    out = torch.full((rows, int(counts.max())), flat.numel(),
                     dtype=torch.int64)
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(flat.numel()) - starts[flat[order]]
    out[flat[order], slot] = order
    return out


class WindowAttention(nn.Module):
    """timm's WindowAttention parameters: the fused qkv and output
    projections and the relative-position bias table."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        rows = (2 * window - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(rows, num_heads))
        index = relative_position_index(window)
        self.register_buffer("relative_position_index", index,
                             persistent=False)
        self.register_buffer("_bias_sources", bias_sources(index, rows),
                             persistent=False)

    def bias(self) -> torch.Tensor:
        """The [H, N, N] bias in the table's dtype."""
        return _BiasGather.apply(self.relative_position_bias_table,
                                 self.relative_position_index,
                                 self._bias_sources)


class SwinBlock(nn.Module):
    """One block on window rows [B * nW, N, C]: x + attention (with the
    bias, and the mask when shifted), then x + MLP."""

    def __init__(self, dim: int, num_heads: int, res: int, window: int,
                 shift: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        # timm's mask, and the region ids the kernels build it from
        self.register_buffer(
            "attn_mask", shift_mask(res, window, shift) if shift else None,
            persistent=False)
        self.register_buffer(
            "attn_regions", shift_regions(res, window, shift) if shift
            else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, m = self.attn, self.mlp
        x = fused_block_attention(x, self.norm1.weight, self.norm1.bias,
                                  a.qkv.weight, a.qkv.bias, a.proj.weight,
                                  a.proj.bias, a.num_heads, self.norm1.eps,
                                  bias=a.bias(), regions=self.attn_regions)
        return fused_block_mlp(x, self.norm2.weight, self.norm2.bias,
                               m.fc1.weight, m.fc1.bias, m.fc2.weight,
                               m.fc2.bias, self.norm2.eps)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm on an f32 (f64 for f64) copy of x."""
    return F.layer_norm(x.to(at_least_f32(x.dtype)), ln.normalized_shape,
                        ln.weight, ln.bias, ln.eps)


class SwinStage(nn.Module):
    """Patch merging (all stages but the first), then the blocks, the
    stream in window order between the stage's two gathers."""

    def __init__(self, dim: int, depth: int, num_heads: int, res: int,
                 window: int, mlp_ratio: float, eps: float,
                 downsample: bool):
        super().__init__()
        self.res = res
        in_dim = dim // 2 if downsample else dim
        if downsample:
            self.downsample = PatchMerging(in_dim, eps)
        if res <= window:             # timm: one window, no shift
            window, shift = res, 0
        else:
            shift = window // 2
        self.window = window
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, res, window, shift if j % 2 else 0,
                      mlp_ratio, eps) for j in range(depth))
        # the gather before each block, and back to raster order after
        layouts = [window_order(res, window, blk.shift)
                   for blk in self.blocks]
        steps, at = [], torch.arange(res * res)       # raster
        for order in layouts + [torch.arange(res * res)]:
            steps.append(torch.argsort(at)[order])
            at = order
        self.identity = [bool((s == torch.arange(res * res)).all())
                         for s in steps]
        self.register_buffer("_gathers", torch.stack(steps),
                             persistent=False)
        self.register_buffer("_inverses", torch.argsort(torch.stack(steps),
                                                        dim=1),
                             persistent=False)

    def _gather(self, x: torch.Tensor, j: int) -> torch.Tensor:
        if self.identity[j]:
            return x
        return _Gather.apply(x, self._gathers[j], self._inverses[j])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, L, C] raster rows in the compute dtype (the previous
        stage's, before patch merging)."""
        if hasattr(self, "downsample"):
            ds = self.downsample
            y = _layer_norm(merge_order(x, 2 * self.res), ds.norm)
            x = F.linear(y.to(x.dtype), cast_weight(ds.reduction.weight,
                                                    x.dtype))
        B, L, C = x.shape
        n = self.window ** 2
        for j, blk in enumerate(self.blocks):
            x = self._gather(x, j)
            x = blk(x.reshape(B * L // n, n, C)).view(B, L, C)
        return self._gather(x, len(self.blocks))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, in_chans: int,
                 eps: float):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=eps)


class SwinTransformer(nn.Module):
    """Swin trunk; NHWC normalized images in, the [B, C_last] f32 feature
    (the mean over the final tokens after the final LayerNorm) out."""

    def __init__(self, img_size: int = 384, patch_size: int = 4,
                 in_chans: int = 3, embed_dim: int = 128,
                 depths: tuple = (2, 2, 18, 2),
                 num_heads: tuple = (4, 8, 16, 32), window_size: int = 12,
                 mlp_ratio: float = 4.0, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans, eps)
        res = img_size // patch_size
        self.layers = nn.ModuleList()
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.layers.append(SwinStage(
                embed_dim * 2 ** i, depth, heads, res // 2 ** i, window_size,
                mlp_ratio, eps, downsample=i > 0))
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype),
                     cast_weight(proj.weight, self.dtype),
                     proj.bias.to(self.dtype), stride=proj.stride)
        x = x.flatten(2).transpose(1, 2)                 # [B, L, C] raster
        x = _layer_norm(x, self.patch_embed.norm).to(self.dtype)
        for stage in self.layers:
            x = stage(x)
        return _layer_norm(x, self.norm).mean(1)
