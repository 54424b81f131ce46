"""Cross-entropy with torch-criterion semantics over masked static batches.

Port of artgraph_tpu/train/losses.py:cross_entropy (without the data-mesh
psum scope). torch.nn.CrossEntropyLoss with class weights divides by the SUM
OF SAMPLE WEIGHTS, not the batch size; padded rows of the static-shape final
batch carry mask 0 and drop out of both sums. The softmax runs in f32 (f64
inputs stay f64).
"""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, C] (any float dtype), labels int [B], class_weights [C],
    mask f32 [B] -> scalar sum(w * nll) / max(sum(w), 1e-12)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    per_sample = -logp.gather(-1, labels[:, None])[:, 0]
    weights = torch.ones_like(per_sample)
    if class_weights is not None:
        weights = class_weights.to(per_sample)[labels]
    if mask is not None:
        weights = weights * mask.to(per_sample)
    return (per_sample * weights).sum() / weights.sum().clamp_min(1e-12)
