"""ResNet-50 (torchvision v1.5) with the reference's state_dict keys.

Port of artgraph_tpu/models/resnet.py (`at_least_f32`, `bn_batch_mask`,
`MixedBatchNorm`, the `conv_bn_kernels_on` gate, `Bottleneck`, `ResNet50`).
Inputs are normalized NHWC float images, as the port's ViT takes them.
Inside, the trunk runs NCHW in `channels_last` memory format (the NHWC input
permuted is already that), so a 1x1 conv's input rows
`x.permute(0, 2, 3, 1).reshape(-1, C)` are a view, not a copy. Convolutions
run in `dtype` on cuDNN, as the JAX package leaves them to XLA; parameters
are f32. The output is the f32 pooled feature [B, 2048].

BatchNorm is `MixedBatchNorm`: one-pass f32 moments
var = max(E[x^2] - E[x]^2, 0), the running statistics updated with torch
momentum 0.1 (flax 0.9) and `running_var` unbiased (n / (n - 1)) while the
normalization uses the biased variance, then the apply folded to
x * a + b with a = bf16(gamma * rstd), b = bf16(beta - mean * gamma * rstd)
in the compute dtype. Eval uses the running statistics. Its keys are
BatchNorm2d's (`weight`, `bias`, `running_mean`, `running_var`,
`num_batches_tracked`), so reference .pt files load with strict=True.

The ragged final batch's statistics must ignore its padded rows. As in the
JAX package, the mask reaches every MixedBatchNorm through a context
variable (`bn_batch_mask`), not an argument, so the model signatures stay
the reference's; the Trainer sets it for a ragged batch only. A second
context variable, `bn_psum_axis`, makes the statistics global over a data
mesh (the Trainer's data-parallel step): each rank's raw sums
(sum x, sum x^2, n) of whichever source (its own rows, its valid rows under
the mask, or the fused unit's epilogue) are summed over the ranks, in one
all-reduce, before the moments are finished.

The fused 1x1-conv + BN-statistics unit (ops/conv_bn.py) replaces each
bottleneck's conv1 -> bn1 statistics and bn2-apply -> ReLU -> conv3 -> bn3
statistics when `conv_bn_kernels_on` opens: train mode, bf16 or f32, no
batch mask, and ARTGRAPH_CONVBN=1 in the environment (the JAX package's own
switch; off by default there and here). With the gate open on a CPU tensor
the unit's plain twin runs.

`ResNet50` is an nn.Sequential that nests as the reference's
`nn.Sequential(*children[:-1])` of torchvision's resnet50 (`0` conv1, `1`
bn1, `2` relu, `3` maxpool, `4`-`7` layer1-4), so `resnet.0.weight`,
`resnet.4.0.conv1.weight`, `resnet.4.0.downsample.1.running_var`, ... come
out with no key map. With `named=True` the same modules carry torchvision's
child names instead (`conv1`, `bn1`, `relu`, `maxpool`, `layer1`-`layer4`),
the keys of the reference's MultiModal ("sansaro") trunk, torchvision's
resnet50 with `fc = Identity` (`resnet.conv1.weight`,
`resnet.layer1.0.conv1.weight`); the forward, the Bottlenecks and the fused
unit's gate are the same in both layouts.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from artgraph_tpu_torch.ops.conv_bn import conv1x1_bn_stats
from artgraph_tpu_torch.parallel.mesh import psum

RESNET_WIDTHS = (64, 128, 256, 512)
# torchvision resnet50's children before avgpool and fc, in order
TORCHVISION_CHILDREN = ("conv1", "bn1", "relu", "maxpool", "layer1",
                        "layer2", "layer3", "layer4")
_F32 = torch.float32


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """f32, or wider if the compute dtype already is."""
    return torch.promote_types(dtype, _F32)


_BATCH_MASK: contextvars.ContextVar = contextvars.ContextVar(
    "bn_batch_mask", default=None)
_BN_AXIS: contextvars.ContextVar = contextvars.ContextVar(
    "bn_psum_axis", default=None)


@contextlib.contextmanager
def bn_batch_mask(mask: torch.Tensor):
    """Make `mask` [B] (1 for a valid row) visible to every MixedBatchNorm
    that runs in this scope: their train-mode statistics then cover the
    valid rows only."""
    token = _BATCH_MASK.set(mask)
    try:
        yield
    finally:
        _BATCH_MASK.reset(token)


@contextlib.contextmanager
def bn_psum_axis(axis: str):
    """Make every MixedBatchNorm in this scope take its train-mode
    statistics over all ranks of the mesh axis `axis`."""
    token = _BN_AXIS.set(axis)
    try:
        yield
    finally:
        _BN_AXIS.reset(token)


class MixedBatchNorm(nn.Module):
    """BatchNorm2d over NCHW with f32 statistics and an apply in
    `apply_dtype` (None: at_least_f32 of the input's dtype)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1,
                 apply_dtype: torch.dtype | None = torch.bfloat16):
        super().__init__()
        self.eps, self.momentum, self.apply_dtype = eps, momentum, apply_dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def _batch_moments(self, x: torch.Tensor, raw_moments):
        """(mean, mean of squares, n) in f32 over the batch's valid rows
        (over every rank's, under bn_psum_axis)."""
        axis = _BN_AXIS.get()
        if axis is not None:
            return self._global_moments(x, raw_moments, axis)
        if raw_moments is not None:
            # sums from the producing kernel's epilogue; callers keep the
            # fused unit off under a batch mask
            s1, s2, n = raw_moments
            return s1.to(_F32) / n, s2.to(_F32) / n, n
        xf = x.to(at_least_f32(x.dtype))
        mask = _BATCH_MASK.get()
        if mask is None:
            n = float(x.shape[0] * x.shape[2] * x.shape[3])
            return xf.mean((0, 2, 3)), xf.square().mean((0, 2, 3)), n
        m = mask.to(xf.dtype).view(-1, 1, 1, 1)
        n = mask.to(_F32).sum() * float(x.shape[2] * x.shape[3])
        return ((xf * m).sum((0, 2, 3)) / n,
                (xf.square() * m).sum((0, 2, 3)) / n, n)

    @staticmethod
    def _global_moments(x: torch.Tensor, raw_moments, axis: str):
        """The moments from the ranks' summed (s1, s2, n), one all-reduce.
        n keeps the dtype of the one-device path's (a tensor of f32 under
        the mask; f64 for its Python float otherwise), so the running
        variance's n / (n - 1) rounds as it does there."""
        if raw_moments is not None:
            s1, s2, n = raw_moments
            s1, s2 = s1.to(_F32), s2.to(_F32)
            n, n_dtype = float(n), torch.float64
        else:
            xf = x.to(at_least_f32(x.dtype))
            mask = _BATCH_MASK.get()
            spatial = float(x.shape[2] * x.shape[3])
            if mask is None:
                s1, s2 = xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))
                n, n_dtype = x.shape[0] * spatial, torch.float64
            else:
                m = mask.to(xf.dtype).view(-1, 1, 1, 1)
                s1 = (xf * m).sum((0, 2, 3))
                s2 = (xf.square() * m).sum((0, 2, 3))
                n, n_dtype = mask.to(_F32).sum() * spatial, _F32
        C = s1.shape[0]
        n = (n.to(s1.dtype).reshape(1) if isinstance(n, torch.Tensor)
             else torch.full((1,), n, dtype=s1.dtype, device=s1.device))
        tot = psum(torch.cat([s1, s2, n]), axis)
        n = tot[2 * C]
        return tot[:C] / n, tot[C:2 * C] / n, n.to(n_dtype)

    def forward(self, x: torch.Tensor, raw_moments=None,
                scale_shift_only: bool = False):
        """raw_moments=(s1, s2, n): per-channel f32 sums of x and x^2 and the
        row count, computed upstream (the fused unit); scale_shift_only
        returns the apply coefficients (a, b) instead of applying them."""
        dt = self.apply_dtype or at_least_f32(x.dtype)
        if self.training:
            mean, mean_sq, n = self._batch_moments(x, raw_moments)
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            with torch.no_grad():
                if isinstance(n, torch.Tensor):
                    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                else:
                    unbiased = var * (n / max(n - 1.0, 1.0))
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var
                                       + self.momentum * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        rstd = torch.rsqrt(var + self.eps)
        a = (self.weight * rstd).to(dt)
        b = (self.bias - mean * self.weight * rstd).to(dt)
        if scale_shift_only:
            return a, b
        C = a.shape[0]
        return x.to(dt) * a.view(1, C, 1, 1) + b.view(1, C, 1, 1)


def conv_bn_kernels_on(dtype: torch.dtype, train: bool) -> bool:
    """Gate of the fused 1x1-conv + BN-statistics unit: train mode, bf16 or
    f32, no batch mask, and ARTGRAPH_CONVBN=1 (read at each call)."""
    return (train and dtype in (torch.bfloat16, _F32)
            and _BATCH_MASK.get() is None
            and os.environ.get("ARTGRAPH_CONVBN", "") == "1")


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> its [B*H*W, C] rows."""
    B, C, H, W = t.shape
    return t.permute(0, 2, 3, 1).reshape(B * H * W, C)


def _nchw(rows: torch.Tensor, B: int, H: int, W: int) -> torch.Tensor:
    """[B*H*W, C] rows -> NCHW in channels_last memory format (a view)."""
    return rows.view(B, H, W, rows.shape[1]).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + skip."""

    def __init__(self, inplanes: int, width: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        norm = lambda c: MixedBatchNorm(c, apply_dtype=dtype)
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = norm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = norm(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = norm(width * 4)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, width * 4, 1, stride=stride, bias=False),
            norm(width * 4)) if downsample else None)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 and conv3 through the unit, the BN statistics from its raw
        moments; conv2 on cuDNN."""
        dt = self.dtype
        B, cin, H, W = x.shape
        width = self.conv1.out_channels
        dummy = torch.zeros(cin, dtype=dt, device=x.device)
        y1, s1, s2 = conv1x1_bn_stats(
            _rows(x), dummy, dummy, self.conv1.weight.view(width, cin), False)
        out = self.bn1(_nchw(y1, B, H, W),
                       raw_moments=(s1, s2, float(B * H * W)))
        out = F.relu(out).to(dt)
        out = _conv(self.conv2, out, dt)
        a2, b2 = self.bn2(out, scale_shift_only=True)
        _, _, H2, W2 = out.shape
        y3, s1, s2 = conv1x1_bn_stats(
            _rows(out), a2, b2, self.conv3.weight.view(4 * width, width), True)
        return self.bn3(_nchw(y3, B, H2, W2),
                        raw_moments=(s1, s2, float(B * H2 * W2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if conv_bn_kernels_on(dt, self.training):
            out = self._fused(x)
        else:
            out = F.relu(self.bn1(_conv(self.conv1, x, dt))).to(dt)
            out = F.relu(self.bn2(_conv(self.conv2, out, dt))).to(dt)
            out = self.bn3(_conv(self.conv3, out, dt))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](_conv(self.downsample[0], x, dt))
        add = at_least_f32(dt)
        return F.relu(out.to(add) + identity.to(add)).to(dt)


class ResNet50(nn.Sequential):
    """The trunk producing the f32 pooled feature [B, 2048] (fc stripped, as
    the reference consumes it). Input: NHWC float images. Children indexed
    `0`-`7`, or with `named` torchvision's names (TORCHVISION_CHILDREN)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.bfloat16, named: bool = False):
        layers, inplanes = [], 64
        for stage, (blocks, width) in enumerate(zip(stage_sizes,
                                                    RESNET_WIDTHS)):
            stride = 1 if stage == 0 else 2
            blocks_ = [Bottleneck(inplanes, width, stride, True, dtype)]
            inplanes = width * 4
            blocks_ += [Bottleneck(inplanes, width, dtype=dtype)
                        for _ in range(blocks - 1)]
            layers.append(nn.Sequential(*blocks_))
        children = [nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
                    MixedBatchNorm(64, apply_dtype=dtype), nn.ReLU(),
                    nn.MaxPool2d(3, stride=2, padding=1), *layers]
        if named:
            super().__init__(OrderedDict(zip(TORCHVISION_CHILDREN, children)))
        else:
            super().__init__(*children)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        # NHWC permuted to NCHW is channels_last already: no copy
        x = x.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self[1](_conv(self[0], x, dt))).to(dt)
        x = self[3](x)            # MaxPool2d pads with -inf
        for layer in list(self)[4:]:
            x = layer(x)
        return x.to(at_least_f32(dt)).mean((2, 3))
