"""Cross-entropy and NLL with torch-criterion semantics over masked batches.

Port of artgraph_tpu/train/losses.py:cross_entropy, nll_loss, smooth_l1,
mse and the data-mesh scope `loss_psum_axis` (nll_loss without the mask no
caller passes).
torch.nn.CrossEntropyLoss with class weights divides by the SUM OF SAMPLE
WEIGHTS, not the batch size; padded rows of the static-shape final batch
carry mask 0 and drop out of both sums. The softmax runs in f32 (f64 inputs
stay f64).

Inside a `loss_psum_axis(axis)` scope (the Trainer's data-parallel step)
the weighted numerator and denominator are summed over the ranks of the
mesh axis BEFORE the division (parallel.mesh.psum, differentiable), so
every rank computes the same GLOBAL torch-semantics mean, exact when the
ranks' weight sums differ (class weights, ragged masks).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from artgraph_tpu_torch.parallel.mesh import psum

_PSUM_AXIS: contextvars.ContextVar = contextvars.ContextVar(
    "loss_psum_axis", default=None)


@contextlib.contextmanager
def loss_psum_axis(axis: str):
    """Make every loss and metric reduction in this scope global over the
    ranks of the mesh axis `axis`."""
    token = _PSUM_AXIS.set(axis)
    try:
        yield
    finally:
        _PSUM_AXIS.reset(token)


def psum_if_sharded(value: torch.Tensor) -> torch.Tensor:
    """`value` summed over the ranks of the active loss_psum_axis scope
    (itself outside one)."""
    axis = _PSUM_AXIS.get()
    return value if axis is None else psum(value, axis)


def _masked(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(values * weights) / max(sum(weights), 1e-12), both sums global
    in a loss_psum_axis scope."""
    num = psum_if_sharded((values * weights).sum())
    den = psum_if_sharded(weights.sum())
    return num / den.clamp_min(1e-12)


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
    return _masked(per_sample, weights)


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
        if _PSUM_AXIS.get() is None:
            return per_elem.mean()
        return _masked(per_elem, torch.ones_like(per_elem))
    w = mask.to(per_elem.dtype).reshape(
        (-1,) + (1,) * (per_elem.dim() - 1)).expand_as(per_elem)
    return _masked(per_elem, w)
