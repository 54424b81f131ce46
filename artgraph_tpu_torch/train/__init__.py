"""Single-device training: the losses, early stopping and the Trainer."""
from artgraph_tpu_torch.train.early_stopping import EarlyStopping
from artgraph_tpu_torch.train.losses import (cross_entropy, mse, nll_loss,
                                             smooth_l1)
from artgraph_tpu_torch.train.trainer import (Trainer, accuracy_metrics, adam,
                                              sgd_momentum)

__all__ = ["EarlyStopping", "cross_entropy", "mse", "nll_loss", "smooth_l1",
           "Trainer", "accuracy_metrics", "adam", "sgd_momentum"]
