"""Minimal torch re-implementations of torchvision ResNet50, timm ViT-B/16 and
timm Swin, used ONLY as numerical oracles in tests (torchvision/timm are not
installed in this container). Architectures follow the public definitions the
reference depends on (torchvision resnet50 v1.5; timm vit_base_patch16_224 of
the 0.4.x era with CLS-pooled forward_features), and for Swin timm's
timm/models/swin_transformer.py (swin_base_patch4_window12_384), written in
plain f32 torch with nothing of the port."""
import math

import torch
import torch.nn as nn


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, width, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet50Oracle(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.inplanes = 64
        self.layer1 = self._make_layer(64, 3, 1)
        self.layer2 = self._make_layer(128, 4, 2)
        self.layer3 = self._make_layer(256, 6, 2)
        self.layer4 = self._make_layer(512, 3, 2)
        self.avgpool = nn.AdaptiveAvgPool2d(1)

    def _make_layer(self, width, blocks, stride):
        downsample = nn.Sequential(
            nn.Conv2d(self.inplanes, width * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(width * 4))
        layers = [Bottleneck(self.inplanes, width, stride, downsample)]
        self.inplanes = width * 4
        for _ in range(blocks - 1):
            layers.append(Bottleneck(self.inplanes, width))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return torch.flatten(self.avgpool(x), 1)


class ViTBlockOracle(nn.Module):
    def __init__(self, dim=768, heads=12, mlp_ratio=4.0):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, dim * 3)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def _attention(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        qkv = self.attn.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        attn = attn.softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.attn.proj(out)

    def forward(self, x):
        x = x + self._attention(self.norm1(x))
        h = self.mlp.fc1(self.norm2(x))
        h = nn.functional.gelu(h)
        return x + self.mlp.fc2(h)


class ViTOracle(nn.Module):
    """timm-0.4-style forward_features: CLS token after final norm."""

    def __init__(self, depth=12, dim=768, heads=12, patch=16, img=224):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, stride=patch)
        n = (img // patch) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, n + 1, dim) * 0.02)
        self.blocks = nn.Sequential(*[ViTBlockOracle(dim, heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, 1000)  # present in timm state_dicts

    def forward_features(self, x):
        B = x.shape[0]
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + self.pos_embed
        x = self.blocks(x)
        return self.norm(x)[:, 0]


def randomize_bn_stats(module, seed=0):
    """Give BN layers non-trivial running stats so eps/layout bugs surface."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
            with torch.no_grad():
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)


# --- timm Swin Transformer ----------------------------------------------------
# timm/models/swin_transformer.py, the non-fused attention path, equation for
# equation. Departures: none in the arithmetic (drop_path_rate is 0, as the
# port runs it; timm's class default is 0.1); the stage layout is timm's
# current one (PatchMerging at the start of stages 1-3 as `downsample`,
# stage 0 with none) and the buffers `relative_position_index` and
# `attn_mask` are not persistent, as in timm; the ClassifierHead is reduced to
# its `fc`, and forward_features returns the mean over the tokens after the
# final norm (timm's global average pool), not the logits.

def timm_window_partition(x, w):
    """[B, H, W, C] -> [B * nW, w, w, C], windows in raster order."""
    B, H, W, C = x.shape
    x = x.view(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, w, w, C)


def timm_window_reverse(windows, w, H, W):
    C = windows.shape[-1]
    x = windows.view(-1, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, H, W, C)


def timm_relative_position_index(win_h, win_w):
    coords = torch.stack(torch.meshgrid(torch.arange(win_h),
                                        torch.arange(win_w), indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += win_h - 1
    relative_coords[:, :, 1] += win_w - 1
    relative_coords[:, :, 0] *= 2 * win_w - 1
    return relative_coords.sum(-1)


def timm_attn_mask(res, window, shift):
    img_mask = torch.zeros((1, res, res, 1))
    cnt = 0
    for h in ((0, -window), (-window, -shift), (-shift, None)):
        for w in ((0, -window), (-window, -shift), (-shift, None)):
            img_mask[:, h[0]:h[1], w[0]:w[1], :] = cnt
            cnt += 1
    mask_windows = timm_window_partition(img_mask, window)
    mask_windows = mask_windows.view(-1, window * window)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


class SwinWindowAttentionOracle(nn.Module):
    def __init__(self, dim, num_heads, window):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             timm_relative_position_index(window, window),
                             persistent=False)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def _get_rel_pos_bias(self):
        n = self.window ** 2
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        return bias.permute(2, 0, 1).contiguous().unsqueeze(0)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.num_heads, -1).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        attn = attn + self._get_rel_pos_bias()
        if mask is not None:
            num_win = mask.shape[0]
            attn = attn.view(-1, num_win, self.num_heads, N, N) + \
                mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, -1)
        return self.proj(x)


class SwinBlockOracle(nn.Module):
    def __init__(self, dim, num_heads, res, window, shift, mlp_ratio=4.0,
                 eps=1e-5):
        super().__init__()
        if res <= window:
            window, shift = res, 0
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = SwinWindowAttentionOracle(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.register_buffer(
            "attn_mask", timm_attn_mask(res, window, shift) if shift else None,
            persistent=False)

    def _attn(self, x):
        B, H, W, C = x.shape
        if self.shift:
            shifted_x = torch.roll(x, shifts=(-self.shift, -self.shift),
                                   dims=(1, 2))
        else:
            shifted_x = x
        x_windows = timm_window_partition(shifted_x, self.window)
        x_windows = x_windows.view(-1, self.window * self.window, C)
        attn_windows = self.attn(x_windows, mask=self.attn_mask)
        attn_windows = attn_windows.view(-1, self.window, self.window, C)
        shifted_x = timm_window_reverse(attn_windows, self.window, H, W)
        if self.shift:
            return torch.roll(shifted_x, shifts=(self.shift, self.shift),
                              dims=(1, 2))
        return shifted_x

    def forward(self, x):
        B, H, W, C = x.shape
        x = x + self._attn(self.norm1(x))
        x = x.reshape(B, -1, C)
        h = nn.functional.gelu(self.mlp.fc1(self.norm2(x)))
        x = x + self.mlp.fc2(h)
        return x.reshape(B, H, W, C)


class SwinPatchMergingOracle(nn.Module):
    """The original Swin's form: x0, x1, x2, x3 sliced and concatenated."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], -1)))


class SwinStageOracle(nn.Module):
    def __init__(self, dim, depth, num_heads, res, window, downsample,
                 mlp_ratio=4.0, eps=1e-5):
        super().__init__()
        self.downsample = (SwinPatchMergingOracle(dim // 2, eps)
                           if downsample else nn.Identity())
        self.blocks = nn.Sequential(*[
            SwinBlockOracle(dim, num_heads, res, window,
                            0 if j % 2 == 0 else window // 2, mlp_ratio, eps)
            for j in range(depth)])

    def forward(self, x):
        return self.blocks(self.downsample(x))


class SwinOracle(nn.Module):
    """timm's SwinTransformer (NHWC inside, NCHW images in)."""

    def __init__(self, img_size=384, patch_size=4, embed_dim=128,
                 depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window=12,
                 mlp_ratio=4.0, eps=1e-5):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size,
                                          stride=patch_size)
        self.patch_embed.norm = nn.LayerNorm(embed_dim, eps=eps)
        res = img_size // patch_size
        self.layers = nn.Sequential(*[
            SwinStageOracle(embed_dim * 2 ** i, d, h, res // 2 ** i, window,
                            i > 0, mlp_ratio, eps)
            for i, (d, h) in enumerate(zip(depths, num_heads))])
        dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.head = nn.Module()
        self.head.fc = nn.Linear(dim, 1000)

    def forward_features(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        x = self.layers(self.patch_embed.norm(x))
        return self.norm(x).mean((1, 2))
