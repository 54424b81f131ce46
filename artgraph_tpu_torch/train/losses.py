"""Cross-entropy and NLL with torch-criterion semantics over masked batches.

Port of artgraph_tpu/train/losses.py:cross_entropy and nll_loss (without the
data-mesh psum scope, and nll_loss without the mask no caller passes).
torch.nn.CrossEntropyLoss with class weights divides by the SUM OF SAMPLE
WEIGHTS, not the batch size; padded rows of the static-shape final batch
carry mask 0 and drop out of both sums. The softmax runs in f32 (f64 inputs
stay f64).
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


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch F.nll_loss over precomputed log-probabilities [N, C]: the mean
    of -log_probs[i, labels[i]], in f32 (f64 inputs stay f64)."""
    log_probs = log_probs.to(torch.promote_types(log_probs.dtype,
                                                 torch.float32))
    return -log_probs.gather(-1, labels.long()[:, None]).mean()
