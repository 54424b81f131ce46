"""Single-device trainer for the image models.

Port of artgraph_tpu/train/trainer.py (`Trainer`, `accuracy_metrics`, `adam`,
`sgd_momentum`) without its mesh, resident-data and epoch-scan branches. The
model's arguments and the loss are functions, as in the JAX trainer:

  forward_inputs(images, batch) -> the model's positional arguments
  compute_loss(outputs, batch) -> (scalar loss, metrics dict)
  eval_compute_loss(outputs, batch), the same in eval_epoch (default
    compute_loss)

where `images` are the normalized images and `batch` the device batch (the
default passes the images alone; the fusion trainers add the embeddings).
The ContextNet / MultiModal trainers train on (image, embedding, label)
batches and evaluate on image-only ones, with a loss of their own for
each.
Each step: the host batch (uint8 NHWC images, any f32 embeddings, labels,
f32 mask) moves to the device, the normalize kernel runs
(ops/preprocess.py), then the model, the loss, `backward()` (the kernels'
backward on cuda) and the optimizer step.
A ragged batch (the host's mask has padded rows) runs under
`bn_batch_mask`, so the BatchNorm statistics of a model that has them cover
its valid rows only, as the reference's smaller unpadded final batch does; a
full batch runs unmasked, and only there can the fused conv + BN-statistics
unit run. A model without BatchNorm (ViT) never reads the mask. The
host decides from the numpy mask it already holds: no device sync.
Metrics accumulate on the device and the host reads them once per
epoch: the loss total weighted by each batch's valid count, as the reference
accumulates `loss.item() * n` (ref: train_baseline.py:68-70), and the other
metrics (masked correct counts) summed.

Random state is explicit: the trainer seeds its device's generator, which
nn.Dropout draws from, with `seed` (GLOBAL_SEED in the CLIs). The dropout
masks are not the JAX package's (another generator).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.models.resnet import bn_batch_mask
from artgraph_tpu_torch.ops import normalize_images

Batch = Tuple[np.ndarray, ...]


def accuracy_metrics(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, prefix: str = ""
                     ) -> Dict[str, torch.Tensor]:
    """Masked correct-prediction count (the reference's accuracy
    numerator), keyed `{prefix}correct`."""
    correct = ((logits.argmax(-1) == labels).to(torch.float32)
               * mask.to(torch.float32)).sum()
    return {f"{prefix}correct": correct}


def image_only(images: torch.Tensor, batch) -> tuple:
    """The default forward_inputs: the model takes the images alone."""
    return (images,)


class Trainer:
    def __init__(self, model: torch.nn.Module,
                 optimizer: Callable[[Iterable[torch.nn.Parameter]],
                                     torch.optim.Optimizer],
                 compute_loss: Callable,
                 transform_type: str = "resnet",
                 device: str | torch.device = "cuda",
                 seed: int = config.GLOBAL_SEED,
                 forward_inputs: Callable = image_only,
                 eval_compute_loss: Optional[Callable] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"Trainer: device {device} requested but "
                                   f"CUDA is not available")
            with torch.cuda.device(self.device):
                torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        self.model = model.to(self.device)
        self.optimizer = optimizer(self.model.parameters())
        self.compute_loss = compute_loss
        self.eval_compute_loss = eval_compute_loss or compute_loss
        self.forward_inputs = forward_inputs
        self.transform_type = transform_type
        self.host_step = 0

    def to_device(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.asarray(b)).to(self.device)
                     for b in batch)

    def _outputs(self, batch: Tuple[torch.Tensor, ...]):
        images = normalize_images(batch[0], self.transform_type)
        return self.model(*self.forward_inputs(images, batch))

    def train_step(self, batch: Tuple[torch.Tensor, ...],
                   ragged: bool = False):
        """One fwd + bwd + update on a device batch (model in train mode);
        returns the loss and metrics as device tensors. `ragged`: the batch's
        mask (its last component) has padded rows."""
        ctx = bn_batch_mask(batch[-1]) if ragged else contextlib.nullcontext()
        with ctx:
            loss, metrics = self.compute_loss(self._outputs(batch), batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.host_step += 1
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    @staticmethod
    def _read(totals: Dict[str, torch.Tensor], examples: float
              ) -> Dict[str, float]:
        keys = list(totals)
        values = torch.stack([totals[k] for k in keys]).tolist() \
            if keys else []
        out = {k: v / examples for k, v in zip(keys, values)}
        out["examples"] = examples
        return out

    @staticmethod
    def _accumulate(totals, loss, metrics, n: float) -> None:
        # reference accumulation: loss.item() * batch_size summed
        totals["loss"] = totals.get("loss", 0.0) + loss * n
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + v

    def train_epoch(self, loader: Iterable[Batch]) -> Dict[str, float]:
        """One pass over the loader's (images, ..., mask) host batches."""
        self.model.train()
        totals: Dict[str, torch.Tensor] = {}
        examples = 0.0
        for batch in loader:
            mask = np.asarray(batch[-1])
            n = float(mask.sum())
            loss, metrics = self.train_step(self.to_device(batch),
                                            ragged=n < mask.size)
            self._accumulate(totals, loss, metrics, n)
            examples += n
        out = self._read(totals, examples)
        if not np.isfinite(out["loss"]):
            # surface divergence at the epoch boundary instead of silently
            # training on NaNs
            raise FloatingPointError(
                f"non-finite training loss {out['loss']} at step "
                f"{self.host_step}; check lr/dtype policy")
        return out

    @torch.no_grad()
    def eval_epoch(self, loader: Iterable[Batch],
                   collect_outputs: bool = False):
        """Mean loss and metrics (eval_compute_loss) over the valid rows;
        with collect_outputs also [(outputs, non-image batch components)]
        per batch, every tensor of the outputs (a tensor, or nested lists
        and tuples of them, as the multitask and context models return) cut
        to the valid rows, as numpy."""
        self.model.eval()
        totals: Dict[str, torch.Tensor] = {}
        examples = 0.0
        collected = []
        for batch in loader:
            n = float(np.asarray(batch[-1]).sum())
            dev = self.to_device(batch)
            outputs = self._outputs(dev)
            loss, metrics = self.eval_compute_loss(outputs, dev)
            self._accumulate(totals, loss, metrics, n)
            examples += n
            if collect_outputs:
                valid = int(n)
                collected.append((
                    _rows_to_numpy(outputs, valid),
                    tuple(np.asarray(b)[:valid] for b in batch[1:-1])))
        out = self._read(totals, examples)
        return (out, collected) if collect_outputs else out


def _rows_to_numpy(outputs, n: int):
    """Every tensor of a tree of lists and tuples cut to its first n rows,
    as numpy; the tree's structure kept."""
    if isinstance(outputs, (list, tuple)):
        return type(outputs)(_rows_to_numpy(o, n) for o in outputs)
    return outputs[:n].cpu().numpy()


# --------------------------------------------------------------------------
# Optimizers with torch-default hyperparameters, as factories over the
# parameters (the JAX package's optax transformations take none)
# --------------------------------------------------------------------------

def adam(lr: float):
    """torch.optim.Adam defaults (betas 0.9/0.999, eps 1e-8) — every
    reference trainer except ContextNet (ref: train_baseline.py:44)."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                           eps=1e-8)


def sgd_momentum(lr: float, momentum: float = 0.9):
    """torch.optim.SGD(momentum=0.9) — ContextNet
    (ref: train_baseline_context.py:49)."""
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum)
