"""Cross-entropy and NLL with torch-criterion semantics over masked batches.

Port of artgraph_tpu/train/losses.py:cross_entropy, nll_loss, smooth_l1
and mse (without the data-mesh psum scope, and nll_loss without the mask no caller
passes).
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


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              beta: float = 1.0) -> torch.Tensor:
    """torch.nn.SmoothL1Loss (Huber with `beta`, the mean over elements) in
    f32 (f64 inputs stay f64); with mask [B] the mean over the valid rows'
    elements."""
    dt = torch.promote_types(pred.dtype, torch.float32)
    diff = (pred.to(dt) - target.to(dt)).abs()
    per_elem = torch.where(diff < beta, 0.5 * diff * diff / beta,
                           diff - 0.5 * beta)
    return _mean_over_rows(per_elem, mask)


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.nn.MSELoss (the mean of the squared error over elements) in f32
    (f64 inputs stay f64); with mask [B] the mean over the valid rows'
    elements."""
    dt = torch.promote_types(pred.dtype, torch.float32)
    return _mean_over_rows((pred.to(dt) - target.to(dt)).square(), mask)


def _mean_over_rows(per_elem: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of per_elem [B, ...], or with mask [B] of its valid rows."""
    if mask is None:
        return per_elem.mean()
    w = mask.to(per_elem.dtype).reshape(
        (-1,) + (1,) * (per_elem.dim() - 1)).expand_as(per_elem)
    return (per_elem * w).sum() / w.sum().clamp_min(1e-12)
