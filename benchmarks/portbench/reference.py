"""The plain reference of the fusion models, and its lower-precision
control.

Plain PyTorch in float32 (TF32 off: `plain_math`), written from the
published descriptions and nothing of the port: the configuration's trunk
(`Plain` of its module under portbench/trunks/: timm's
vit_base_patch16_224, torchvision's ResNet50 v1.5), and the reference
repository's NewMultiModalMultiTask(ViT) heads: Dropout then Linear on
cat([trunk feature, KG embedding]) for style and genre, the 0.5/0.5
cross-entropy, and torch's Adam. Parameter names are the reference
state_dict's, so one set of seeded weights loads into the port's model and
into this one by name.

`precision="fp8"` is the control: every matrix product and convolution of
the trunk takes its operands rounded to float8 e4m3 and its output's
gradient rounded to float8 e5m2 (per-tensor scales, f32 accumulation), the
activations that the program stores in bf16 (the residual stream, the
BatchNorm outputs) are stored in e4m3 with e5m2 gradients, and the heads
run in bfloat16: the step below the configuration's bf16 trunk and f32
heads. Dropout draws from the device's default generator in the order
the heads run, so a run seeded as the program's trainer seeds draws the
program's masks.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench import trunks

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def plain_math():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to a float8 format with one per-tensor scale."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _OperandFp8(torch.autograd.Function):
    """The operand rounded to e4m3; the gradient passed through (the
    product's output gradient is rounded where it enters, _GradFp8)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradFp8(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class _ActFp8(torch.autograd.Function):
    """A stored activation: rounded to e4m3, its gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """Where the control rounds: the trunk's product operands and output
    gradients, and the activations the program stores in its compute dtype
    (the residual stream, BatchNorm's outputs), to fp8; the heads' dtype
    (bf16). 'f32' rounds nothing."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.heads = torch.bfloat16 if name == "fp8" else torch.float32

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "f32" else _OperandFp8.apply(t)

    def output(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "f32" else _GradFp8.apply(t)

    def act(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "f32" else _ActFp8.apply(t)


def linear(p: Precision, x, lin: nn.Linear):
    return p.output(F.linear(p.operand(x), p.operand(lin.weight), lin.bias))


def conv(p: Precision, x, c: nn.Conv2d):
    return p.output(F.conv2d(p.operand(x), p.operand(c.weight), c.bias,
                             c.stride, c.padding))


# --- the fusion model ----------------------------------------------------------

def _head(in_dim: int, n: int) -> nn.Sequential:
    return nn.Sequential(nn.Dropout(), nn.Linear(in_dim, n))


class PlainFusion(nn.Module):
    """NewMultiModalMultiTask(ViT): trunk, then per task Dropout + Linear on
    cat([feature, embedding]); returns [style logits, genre logits]."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        trunk = trunks.get(cfg)
        self.trunk_name = trunk.PREFIX
        setattr(self, self.trunk_name, trunk.Plain(cfg))
        dim = trunk.feature_dim(cfg)
        self.class_style = _head(dim + cfg["emb_size"],
                                 cfg["num_classes"]["style"])
        self.class_genre = _head(dim + cfg["emb_size"],
                                 cfg["num_classes"]["genre"])

    def normalize(self, images_u8: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.cfg["normalize"]["mean"],
                            device=images_u8.device)
        std = torch.tensor(self.cfg["normalize"]["std"],
                           device=images_u8.device)
        return (images_u8.float() / 255.0 - mean) / std

    def forward(self, images_u8, emb_style, emb_genre, p: Precision,
                train: bool):
        feat = getattr(self, self.trunk_name)(self.normalize(images_u8), p)
        out = []
        for head, emb in ((self.class_style, emb_style),
                          (self.class_genre, emb_genre)):
            z = torch.cat([feat, emb.float()], 1)
            z = F.dropout(z, self.cfg["dropout"], training=train)
            lin = head[1]
            out.append(F.linear(z.to(p.heads), lin.weight.to(p.heads),
                                lin.bias.to(p.heads)).float())
        return out


def fusion_loss(cfg: dict, logits, labels: torch.Tensor,
                rows: int | None = None) -> torch.Tensor:
    """w_style CE(style) + w_genre CE(genre), the mean over the batch (over
    its first `rows` rows when given)."""
    w = cfg["loss_weights"]
    sl = slice(None) if rows is None else slice(0, rows)
    return (w["style"] * F.cross_entropy(logits[0][sl], labels[sl, 0].long())
            + w["genre"] * F.cross_entropy(logits[1][sl],
                                           labels[sl, 1].long()))


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), written
    out."""

    def __init__(self, params, lr: float, betas, eps: float):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(self.b1).add_(p.grad, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def decode_resize(path: str, size: int) -> np.ndarray:
    """The reference loader's image: open, force RGB, bilinear resize to
    size x size, uint8 HWC."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(path) as im:
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im.resize((size, size), Image.BILINEAR),
                          dtype=np.uint8)
