"""Every classifier, fusion and context model of the reference and the two
visual -> KG-embedding projectors, with the reference's keys.

Port of artgraph_tpu/models/heads.py (ResnetSingleTask, ResnetMultiTask,
ViTSingleTask, ViTMultiTask, ContextNetSingleTask, ContextNetlMultiTask,
MultiModalSingleTask, MultiModalMultiTask, NewMultiModalSingleTask,
NewMultiModalMultiTask, NewMultiModalSingleTaskVit,
NewMultiModalMultiTaskViT, LabelProjector, LabelProjectorVit). Module
nesting
reproduces the reference state_dict exactly (artgraph_tpu/checkpointing/
torch_interop.py `_MODEL_SPECS`):

  * the ResNet models hold the trunk as `resnet` (the reference's
    Sequential(*children[:-1]), models/resnet.py) and Sequential(Dropout,
    Linear) heads (`classifier.1.*`, `style_classifier.1.*`,
    `class_style.1.*`, ...);
  * ViTSingleTask replaces timm's `vit.head` with Sequential(Dropout, Linear),
    so its classifier keys are `vit.head.1.*`;
  * the other three ViT models keep timm's unused 1000-class `vit.head` and
    carry their own Sequential(Dropout, Linear) heads;
  * the projectors are the trunk (ResNet as `resnet`, ViT as `vit` with
    timm's unused head) and a bare Linear `encoder` onto the embedding
    width, computed in f32 on the f32 feature (the JAX package's Dense with
    dtype f32);
  * ContextNet (Garcia et al.; ref: src/models/models_kg.py:7-61) puts bare
    Linears `classifier` (or `class_style`, `class_genre`) and `encoder` on
    the indexed trunk, no dropout;
  * MultiModal ("sansaro", Castellano et al.; ref: models_kg.py:63-137)
    keeps torchvision's named trunk keys (`resnet.conv1.weight`: its fc is
    an Identity, ResNet50(named=True)), a `_TanhEncoder` `encoder`
    (`encoder.0.*`, `encoder.2.*`) onto the embedding width, and
    Sequential(Dropout(0.2), Linear) heads on cat([feature, projection]).

The context models return (logits, graph_proj) or ([style, genre],
graph_proj), as the JAX ones. The heads' Dropout is active in train().
Logits are f32: the heads run in f32 on the f32 feature (ResNet's pooled
2048-d one, ViT's CLS token), and the fusion models concatenate that
feature with the f32 embedding first.
"""
from __future__ import annotations

import torch
from torch import nn

from artgraph_tpu_torch.models.resnet import ResNet50
from artgraph_tpu_torch.models.vit import ViT

RESNET_DIM = 2048
TIMM_HEAD_CLASSES = 1000


def _head(in_dim: int, num_out: int, dropout: float) -> nn.Sequential:
    return nn.Sequential(nn.Dropout(dropout), nn.Linear(in_dim, num_out))


def _vit_with_timm_head(dtype: torch.dtype) -> ViT:
    vit = ViT(dtype=dtype)
    # present, never called
    vit.head = nn.Linear(vit.embed_dim, TIMM_HEAD_CLASSES)
    return vit


def _cat_f32(feat: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    return torch.cat([feat, emb.to(torch.float32)], dim=1)


class ResnetSingleTask(nn.Module):
    def __init__(self, num_class: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype)
        self.classifier = _head(RESNET_DIM, num_class, dropout)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.resnet(img))


class ResnetMultiTask(nn.Module):
    def __init__(self, num_classes: dict[str, int], dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype)
        dim = RESNET_DIM
        self.style_classifier = _head(dim, num_classes["style"], dropout)
        self.genre_classifier = _head(dim, num_classes["genre"], dropout)

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        feat = self.resnet(img)
        return [self.style_classifier(feat), self.genre_classifier(feat)]


class ContextNetSingleTask(nn.Module):
    def __init__(self, emb_size: int, num_class: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype)
        self.classifier = nn.Linear(RESNET_DIM, num_class)
        self.encoder = nn.Linear(RESNET_DIM, emb_size)

    def forward(self, img: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.resnet(img)
        return self.classifier(feat), self.encoder(feat)


class ContextNetlMultiTask(nn.Module):
    """The reference's spelling; ContextNetMultiTask is an alias."""

    def __init__(self, emb_size: int, num_classes: dict[str, int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype)
        self.encoder = nn.Linear(RESNET_DIM, emb_size)
        self.class_style = nn.Linear(RESNET_DIM, num_classes["style"])
        self.class_genre = nn.Linear(RESNET_DIM, num_classes["genre"])

    def forward(self, img: torch.Tensor
                ) -> tuple[list[torch.Tensor], torch.Tensor]:
        feat = self.resnet(img)
        return ([self.class_style(feat), self.class_genre(feat)],
                self.encoder(feat))


ContextNetMultiTask = ContextNetlMultiTask

# the MultiModal heads' dropout, fixed in the reference (models_kg.py:63-137)
MULTIMODAL_DROPOUT = 0.2


class _TanhEncoder(nn.Sequential):
    """Linear -> tanh -> Linear -> tanh onto the embedding width."""

    def __init__(self, in_dim: int, emb_size: int):
        super().__init__(nn.Linear(in_dim, emb_size), nn.Tanh(),
                         nn.Linear(emb_size, emb_size), nn.Tanh())


class MultiModalSingleTask(nn.Module):
    def __init__(self, emb_size: int, num_class: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype, named=True)
        self.encoder = _TanhEncoder(RESNET_DIM, emb_size)
        self.classifier = _head(RESNET_DIM + emb_size, num_class,
                                MULTIMODAL_DROPOUT)

    def forward(self, img: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.resnet(img)
        graph_proj = self.encoder(feat)
        return self.classifier(torch.cat([feat, graph_proj], 1)), graph_proj


class MultiModalMultiTask(nn.Module):
    def __init__(self, emb_size: int, num_classes: dict[str, int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype, named=True)
        self.encoder = _TanhEncoder(RESNET_DIM, emb_size)
        dim = RESNET_DIM + emb_size
        self.class_style = _head(dim, num_classes["style"],
                                 MULTIMODAL_DROPOUT)
        self.class_genre = _head(dim, num_classes["genre"],
                                 MULTIMODAL_DROPOUT)

    def forward(self, img: torch.Tensor
                ) -> tuple[list[torch.Tensor], torch.Tensor]:
        feat = self.resnet(img)
        graph_proj = self.encoder(feat)
        concat = torch.cat([feat, graph_proj], 1)
        return [self.class_style(concat), self.class_genre(concat)], graph_proj


class NewMultiModalSingleTask(nn.Module):
    def __init__(self, emb_size: int, num_class: int, dropout: float = 0.4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype)
        self.classifier = _head(RESNET_DIM + emb_size, num_class,
                                dropout)

    def forward(self, img: torch.Tensor,
                embedding: torch.Tensor) -> torch.Tensor:
        return self.classifier(_cat_f32(self.resnet(img), embedding))


class NewMultiModalMultiTask(nn.Module):
    def __init__(self, emb_size: int, num_classes: dict[str, int],
                 dropout: float = 0.4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype)
        dim = RESNET_DIM + emb_size
        self.class_style = _head(dim, num_classes["style"], dropout)
        self.class_genre = _head(dim, num_classes["genre"], dropout)

    def forward(self, img: torch.Tensor, embedding_style: torch.Tensor,
                embedding_genre: torch.Tensor) -> list[torch.Tensor]:
        feat = self.resnet(img)
        return [self.class_style(_cat_f32(feat, embedding_style)),
                self.class_genre(_cat_f32(feat, embedding_genre))]


class ViTSingleTask(nn.Module):
    def __init__(self, num_class: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vit = ViT(dtype=dtype)
        self.vit.head = _head(self.vit.embed_dim, num_class, dropout)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.vit.head(self.vit(img))


class ViTMultiTask(nn.Module):
    def __init__(self, num_classes: dict[str, int], dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vit = _vit_with_timm_head(dtype)
        dim = self.vit.embed_dim
        self.style_classifier = _head(dim, num_classes["style"], dropout)
        self.genre_classifier = _head(dim, num_classes["genre"], dropout)

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        feat = self.vit(img)
        return [self.style_classifier(feat), self.genre_classifier(feat)]


class NewMultiModalSingleTaskVit(nn.Module):
    def __init__(self, emb_size: int, num_class: int, dropout: float = 0.4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vit = _vit_with_timm_head(dtype)
        self.classifier = _head(self.vit.embed_dim + emb_size, num_class,
                                dropout)

    def forward(self, img: torch.Tensor,
                embedding: torch.Tensor) -> torch.Tensor:
        return self.classifier(_cat_f32(self.vit(img), embedding))


class NewMultiModalMultiTaskViT(nn.Module):
    def __init__(self, emb_size: int, num_classes: dict[str, int],
                 dropout: float = 0.4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vit = _vit_with_timm_head(dtype)
        dim = self.vit.embed_dim + emb_size
        self.class_style = _head(dim, num_classes["style"], dropout)
        self.class_genre = _head(dim, num_classes["genre"], dropout)

    def forward(self, img: torch.Tensor, embedding_style: torch.Tensor,
                embedding_genre: torch.Tensor) -> list[torch.Tensor]:
        feat = self.vit(img)
        return [self.class_style(_cat_f32(feat, embedding_style)),
                self.class_genre(_cat_f32(feat, embedding_genre))]


class LabelProjector(nn.Module):
    def __init__(self, emb_size: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.resnet = ResNet50(dtype=dtype)
        self.encoder = nn.Linear(RESNET_DIM, emb_size)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.resnet(img).to(torch.float32))


class LabelProjectorVit(nn.Module):
    def __init__(self, emb_size: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vit = _vit_with_timm_head(dtype)
        self.encoder = nn.Linear(self.vit.embed_dim, emb_size)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.vit(img).to(torch.float32))
