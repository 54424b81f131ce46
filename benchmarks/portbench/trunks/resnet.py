"""torchvision's ResNet50 v1.5 trunk (the stride on the 3x3, BatchNorm on
the batch's biased variance in training), held as `resnet` by the port's
NewMultiModalMultiTask and by the plain model."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from portbench.flops import resnet_forward_flops as forward_flops  # noqa: F401
from portbench.reference import Precision, conv

PREFIX = "resnet"
TINY = {"img_size": 32, "stage_sizes": [1, 1, 1, 1]}


def fusion_class():
    from artgraph_tpu_torch.models import NewMultiModalMultiTask
    return NewMultiModalMultiTask


def feature_dim(cfg: dict) -> int:
    return cfg["widths"][-1] * cfg["expansion"]


def init_scale(name: str, shape: tuple, cfg: dict):
    """The last BatchNorm weight of each residual branch (bn3): offset g and
    std 0.1 g where the configuration gives g as init_residual_gamma."""
    g = cfg.get("init_residual_gamma")
    if g is not None and name.endswith("bn3.weight"):
        return g, 0.1 * g
    return None


def patch_tiny(monkeypatch) -> None:
    from artgraph_tpu_torch.models import heads, resnet
    monkeypatch.setattr(heads, "ResNet50", functools.partial(
        resnet.ResNet50, stage_sizes=tuple(TINY["stage_sizes"])))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d's parameters and buffers; the forward normalizes by the
    batch's mean and biased variance in training, the running statistics
    in eval."""

    def forward(self, x):
        if self.training:
            mean = x.mean((0, 2, 3), keepdim=True)
            var = x.var((0, 2, 3), unbiased=False, keepdim=True)
        else:
            mean = self.running_mean.view(1, -1, 1, 1)
            var = self.running_var.view(1, -1, 1, 1)
        return ((x - mean) * torch.rsqrt(var + self.eps)
                * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1))


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, down: bool,
                 e: int, eps: float):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm(width, eps=eps)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(width, eps=eps)
        self.conv3 = nn.Conv2d(width, width * e, 1, bias=False)
        self.bn3 = BatchNorm(width * e, eps=eps)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, width * e, 1, stride, bias=False),
            BatchNorm(width * e, eps=eps)) if down else None)

    def forward(self, x, p: Precision):
        out = F.relu(p.act(self.bn1(conv(p, x, self.conv1))))
        out = F.relu(p.act(self.bn2(conv(p, out, self.conv2))))
        out = p.act(self.bn3(conv(p, out, self.conv3)))
        idt = x if self.downsample is None else p.act(self.downsample[1](
            conv(p, x, self.downsample[0])))
        return p.act(F.relu(out + idt))


class PlainResNet50(nn.Sequential):
    """torchvision's resnet50 without avgpool and fc, indexed 0-7 as the
    reference repository's nn.Sequential(*children[:-1]): NHWC normalized
    images in, the pooled feature [B, 2048] out."""

    def __init__(self, cfg: dict):
        eps, e = cfg["bn_eps"], cfg["expansion"]
        layers, cin = [], cfg["widths"][0]
        for stage, (n, w) in enumerate(zip(cfg["stage_sizes"],
                                           cfg["widths"])):
            blocks = []
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(_Bottleneck(cin, w, stride, b == 0, e, eps))
                cin = w * e
            layers.append(nn.Sequential(*blocks))
        super().__init__(
            nn.Conv2d(3, cfg["widths"][0], 7, 2, 3, bias=False),
            BatchNorm(cfg["widths"][0], eps=eps), nn.ReLU(),
            nn.MaxPool2d(3, 2, 1), *layers)

    def forward(self, x, p: Precision):
        x = F.relu(p.act(self[1](conv(p, x.permute(0, 3, 1, 2), self[0]))))
        x = self[3](x)
        for layer in list(self)[4:]:
            for blk in layer:
                x = blk(x, p)
        return x.mean((2, 3))


Plain = PlainResNet50
