"""Patience-based early stopping / best-checkpoint selector.

Port of artgraph_tpu/train/early_stopping.py (ref src/models/models.py:9-39
`EarlyStopping`): the monitored quantity is the NEGATED validation loss; an
epoch counts as an improvement only when -loss >= best + min_delta, and each
improvement saves a checkpoint through `save_fn(model_state, path)`. The
wait counter resets on improvement, as the JAX package's does (the reference
resets an unused attribute instead, models.py:35, so its counter never
resets); `legacy_counter_bug=True` reproduces the reference's `wait` and
`stop` trajectory, as the JAX flag does. Reference trainers ignore `.stop`:
the epoch loop runs all epochs and early stopping only selects the saved
checkpoint, identical either way.
"""
from __future__ import annotations

from typing import Callable, Optional


class EarlyStopping:
    def __init__(self, patience: int = 3, min_delta: float = 0.001,
                 checkpoint_path: str = "checkpoint.pt",
                 save_fn: Optional[Callable[[object, str], None]] = None,
                 legacy_counter_bug: bool = False):
        self.patience = patience
        self.min_delta = min_delta
        self.best_loss = None
        self.stop = False
        self.wait = 0
        self.path = checkpoint_path
        self.save_fn = save_fn
        self.legacy_counter_bug = legacy_counter_bug

    def __call__(self, current_loss: float, model_state) -> None:
        loss = -float(current_loss)
        if self.best_loss is None:
            self.best_loss = loss
            self.save_checkpoint(model_state)
        elif loss < self.best_loss + self.min_delta:
            self.wait += 1
            print(f"EarlyStopping counter: {self.wait} out of {self.patience}")
            if self.wait >= self.patience:
                self.stop = True
        else:
            self.best_loss = loss
            self.save_checkpoint(model_state)
            if not self.legacy_counter_bug:
                self.wait = 0

    def save_checkpoint(self, model_state) -> None:
        print("Validation loss decreased. Saving model...")
        if self.save_fn is not None:
            self.save_fn(model_state, self.path)
