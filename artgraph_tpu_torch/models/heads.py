"""The four ViT classifier and fusion models, with the reference's keys.

Port of artgraph_tpu/models/heads.py (ViTSingleTask, ViTMultiTask,
NewMultiModalSingleTaskVit, NewMultiModalMultiTaskViT). Module nesting
reproduces the reference state_dict exactly (artgraph_tpu/checkpointing/
torch_interop.py `_MODEL_SPECS`):

  * ViTSingleTask replaces timm's `vit.head` with Sequential(Dropout, Linear),
    so its classifier keys are `vit.head.1.*`;
  * the other three keep timm's unused 1000-class `vit.head` and carry their
    own Sequential(Dropout, Linear) heads (`class_style.1.*`, ...).

The heads' Dropout is active in train(). Logits are f32: the heads run in
f32 on the f32 CLS feature, and the fusion models concatenate that feature
with the f32 embedding first.
"""
from __future__ import annotations

import torch
from torch import nn

from artgraph_tpu_torch.models.vit import ViT

VIT_DIM = 768
TIMM_HEAD_CLASSES = 1000


def _head(in_dim: int, num_out: int, dropout: float) -> nn.Sequential:
    return nn.Sequential(nn.Dropout(dropout), nn.Linear(in_dim, num_out))


def _vit_with_timm_head(dtype: torch.dtype) -> ViT:
    vit = ViT(dtype=dtype)
    vit.head = nn.Linear(VIT_DIM, TIMM_HEAD_CLASSES)  # present, never called
    return vit


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
        self.style_classifier = _head(VIT_DIM, num_classes["style"], dropout)
        self.genre_classifier = _head(VIT_DIM, num_classes["genre"], dropout)

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        feat = self.vit(img)
        return [self.style_classifier(feat), self.genre_classifier(feat)]


class NewMultiModalSingleTaskVit(nn.Module):
    def __init__(self, emb_size: int, num_class: int, dropout: float = 0.4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vit = _vit_with_timm_head(dtype)
        self.classifier = _head(VIT_DIM + emb_size, num_class, dropout)

    def forward(self, img: torch.Tensor,
                embedding: torch.Tensor) -> torch.Tensor:
        feat = self.vit(img)
        return self.classifier(
            torch.cat([feat, embedding.to(torch.float32)], dim=1))


class NewMultiModalMultiTaskViT(nn.Module):
    def __init__(self, emb_size: int, num_classes: dict[str, int],
                 dropout: float = 0.4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vit = _vit_with_timm_head(dtype)
        self.class_style = _head(VIT_DIM + emb_size, num_classes["style"],
                                 dropout)
        self.class_genre = _head(VIT_DIM + emb_size, num_classes["genre"],
                                 dropout)

    def forward(self, img: torch.Tensor, embedding_style: torch.Tensor,
                embedding_genre: torch.Tensor) -> list[torch.Tensor]:
        feat = self.vit(img)
        return [
            self.class_style(
                torch.cat([feat, embedding_style.to(torch.float32)], dim=1)),
            self.class_genre(
                torch.cat([feat, embedding_genre.to(torch.float32)], dim=1)),
        ]
