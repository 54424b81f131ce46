"""The trainer of the image models, on one device or over a data mesh.

Port of artgraph_tpu/train/trainer.py (`Trainer`, `accuracy_metrics`, `adam`,
`sgd_momentum`). The model's arguments and the loss are functions, as in the
JAX trainer:

  forward_inputs(images, batch) -> the model's positional arguments
  compute_loss(outputs, batch) -> (scalar loss, metrics dict)
  eval_compute_loss(outputs, batch), the same in eval_epoch (default
    compute_loss)

where `images` are the normalized images and `batch` the device batch (the
default passes the images alone; the fusion trainers add the embeddings).
The ContextNet / MultiModal trainers train on (image, embedding, label)
batches and evaluate on image-only ones, with a loss of their own for
each.
Each step: the batch (uint8 NHWC images, any f32 embeddings, labels, f32
mask) on the device, the normalize kernel (ops/preprocess.py), the model,
the loss, `backward()` (the kernels' backward on cuda) and the optimizer
step. A ragged batch (the mask has padded rows) of a model with BatchNorm
runs under `bn_batch_mask`, so its statistics cover the valid rows only, as
the reference's smaller unpadded final batch does; a full batch runs
unmasked, and only there can the fused conv + BN-statistics unit run. A
model without BatchNorm (ViT) never reads the mask. The host decides from
the valid count it already holds: no device sync.
Metrics accumulate on the device and the host reads them once per epoch:
the loss total weighted by each batch's valid count, as the reference
accumulates `loss.item() * n` (ref: train_baseline.py:68-70), and the other
metrics (masked correct counts) summed.

The fast paths of the JAX trainer, on cuda:

  * one program a step: as the JAX step is one XLA program, every full
    training batch (and a padded ragged one of a model without BatchNorm)
    runs as one CUDA graph replay: normalize, forward, loss, backward, the
    optimizer step and the metric totals. A graph is captured per key
    (train or eval, the batch's shapes and dtypes, the ARTGRAPH_CONVBN
    gate) after one eager step on a side stream, which is that batch's own
    step and creates the optimizer's state, the kernels' library and its
    once-per-process attributes and the cuBLAS and cuDNN handles. The
    inputs are static buffers the batch is copied into, the gradients live
    in the graph's pool, and Adam runs capturable and fused (adam()).
    The eager steps on cuda are those warm-ups, a BatchNorm model's ragged
    tail, and `train_step` called directly; a failed capture or replay
    raises. Evaluation has graphs of its own (eval mode, no gradients).
    The launch counters (ops/launches.py) gain the captured step's counts
    at each replay;
  * the next host batch is assembled into pinned buffers and copied on a
    side stream by a background thread while the current one runs
    (`_prefetched`); on the CPU the thread only assembles;
  * a `ResidentLoader` (data/resident.py) runs an epoch from its index and
    mask matrices, one upload each: the gather from the resident data is
    inside the captured step, and each step copies its row of the matrices
    into the graph's static buffers, device to device. With
    `epoch_scan=False` the loader's per-batch `device_iter()` feeds the
    same graphed step instead.
Off cuda every step runs eagerly, through the same code. Under a profiler
the step's work sits in the spans of profiling.py: `ag.trainer.replay`,
`ag.trainer.capture`, `ag.trainer.eager_step`, and `ag.trainer.wait_batch`
for the wait on the host loader's queue.

Random state is explicit: the trainer seeds its device's generator, which
nn.Dropout draws from, with `seed` (GLOBAL_SEED in the CLIs); a graph
replay advances it as the eager step would. The dropout masks are not the
JAX package's (another generator).

Data parallelism (`mesh=`, a parallel.mesh.DataMesh; the JAX trainer's
shard_map step): each rank is a process with its own device and its own
block of `batch_size / N` rows of every global batch, from a loader built
with the same mesh (data/loader.py, data/resident.py; a loader of another
mesh, or of none, is refused). The trainer broadcasts rank 0's parameters
and buffers at construction, and each step runs under `loss_psum_axis` and
`bn_psum_axis`: the loss's weighted numerator and denominator, the correct
counts and the BatchNorm raw moments are summed over the ranks, so the
loss, the metrics and the running statistics are the global batch's on
every rank. After the backward, `sync_grads` averages the gradients: each
rank's backward through the psums holds N times its share of the global
gradient (parallel/mesh.py), so the pmean is the global gradient, as in
the JAX step. The optimizer then updates every rank's replica alike.
Dropout draws from a generator seeded per data coordinate (coordinate 0
keeps `seed`), the analog of JAX's fold_in(rng, axis_index). A ragged last batch runs its
masked step on every rank (the ragged test is global: the loaders give the
global valid counts). Evaluation's metrics are global the same way; with
collect_outputs each batch's outputs and labels are gathered from the ranks
in rank order, the global batch's order, and cut to its valid rows. Under
NCCL the step is the graphed one, its collectives captured with it (the
eager warm-up step runs them first); gloo collectives cannot be captured,
so under gloo (the CPU, or ranks sharing one card) every step is eager.
A `data` x `model` mesh (tensor parallelism: a model placed by
parallel.mesh.shard_params with rules before the Trainer is built) runs the
same step: each rank takes block d of every batch, the reductions above run
over `data`, and the column-parallel Linears gather their outputs over
`model` inside the forward.
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from artgraph_tpu_torch import config, profiling
from artgraph_tpu_torch.data.loader import pipeline
from artgraph_tpu_torch.models.resnet import bn_batch_mask, bn_psum_axis
from artgraph_tpu_torch.ops import launches, normalize_images
from artgraph_tpu_torch.parallel.mesh import (global_batch_array, psum,
                                              replicated, sync_grads)
from artgraph_tpu_torch.train.losses import (loss_psum_axis,
                                             psum_if_sharded)

Batch = Tuple[np.ndarray, ...]

# Adam(capturable=True) warns on each eager step; the eager steps here are
# the documented ones (the warm-ups, ragged tails, train_step)
_CAPTURABLE_EAGER = "This instance was constructed with capturable=True"


def accuracy_metrics(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, prefix: str = ""
                     ) -> Dict[str, torch.Tensor]:
    """Masked correct-prediction count (the reference's accuracy
    numerator), keyed `{prefix}correct`; global over the mesh inside a
    loss_psum_axis scope."""
    correct = ((logits.argmax(-1) == labels).to(torch.float32)
               * mask.to(torch.float32)).sum()
    return {f"{prefix}correct": psum_if_sharded(correct)}


def image_only(images: torch.Tensor, batch) -> tuple:
    """The default forward_inputs: the model takes the images alone."""
    return (images,)


class _Graph:
    """One captured step: the graph, its static inputs and outputs, and the
    launches of each counter that one replay makes."""

    def __init__(self, graph, inputs, outputs, counts):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.counts = counts


def _signature(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _conv_bn_gate() -> bool:
    """ARTGRAPH_CONVBN as models/resnet.py:conv_bn_kernels_on reads it."""
    return os.environ.get("ARTGRAPH_CONVBN", "") == "1"


def _tree(fn, tree):
    """fn on every tensor of a tree of lists and tuples."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, t) for t in tree)
    return fn(tree)


class Trainer:
    def __init__(self, model: torch.nn.Module,
                 optimizer: Callable[[Iterable[torch.nn.Parameter]],
                                     torch.optim.Optimizer],
                 compute_loss: Callable,
                 transform_type: str = "resnet",
                 device: str | torch.device = "cuda",
                 seed: int = config.GLOBAL_SEED,
                 forward_inputs: Callable = image_only,
                 eval_compute_loss: Optional[Callable] = None,
                 mesh=None):
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.device)
        if mesh is not None:
            # by the data coordinate: the ranks of one `model` subgroup see
            # the same rows and must draw the same dropout masks
            seed = seed + _RANK_SEED_STRIDE * mesh.rank
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"Trainer: device {device} requested but "
                                   f"CUDA is not available")
            with torch.cuda.device(self.device):
                torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        self.model = model.to(self.device)
        if mesh is not None:
            replicated(self.model, mesh)
        # one CUDA graph a step on cuda, but not under gloo, whose
        # collectives cannot be captured
        self.graphed = self.device.type == "cuda" and (
            mesh is None or mesh.backend == "nccl")
        self.optimizer = optimizer(self.model.parameters())
        self.compute_loss = compute_loss
        self.eval_compute_loss = eval_compute_loss or compute_loss
        self.forward_inputs = forward_inputs
        self.transform_type = transform_type
        self.host_step = 0
        self.has_bn = any(name.endswith("running_mean")
                          for name, _ in self.model.named_buffers())
        # device totals of the epoch, updated in place by eager steps and
        # graph replays alike (a graph holds their addresses)
        self._totals: Dict[str, Dict[str, torch.Tensor]] = {
            "train": {}, "eval": {}}
        self.graphs: Dict[tuple, _Graph] = {}
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def to_device(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.asarray(b)).to(self.device)
                     for b in batch)

    def _outputs(self, batch: Tuple[torch.Tensor, ...]):
        images = normalize_images(batch[0], self.transform_type)
        return self.model(*self.forward_inputs(images, batch))

    def _global(self):
        """Over a mesh, the scope in which losses, metrics and BatchNorm
        statistics are global."""
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(loss_psum_axis(self.mesh.axis_name))
            stack.enter_context(bn_psum_axis(self.mesh.axis_name))
        return stack

    def _step(self, batch: Tuple[torch.Tensor, ...], ragged: bool):
        """fwd + bwd + update; the loss and metrics as device tensors."""
        ctx = bn_batch_mask(batch[-1]) if ragged else contextlib.nullcontext()
        with ctx, self._global():
            loss, metrics = self.compute_loss(self._outputs(batch), batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            sync_grads(self.model.parameters(), self.mesh)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_CAPTURABLE_EAGER)
            self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch: Tuple[torch.Tensor, ...],
                   ragged: bool = False):
        """One eager fwd + bwd + update on a device batch (model in train
        mode); returns the loss and metrics as device tensors. `ragged`: the
        batch's mask (its last component) has padded rows."""
        with profiling.annotate("ag.trainer.eager_step"):
            out = self._step(batch, ragged)
        self.host_step += 1
        return out

    def _accumulate(self, totals: Dict[str, torch.Tensor], loss, metrics,
                    mask: torch.Tensor) -> None:
        """Add a batch to the device totals in place: the loss weighted by
        its valid count (the reference's loss.item() * n; the global batch's
        over a mesh), the metrics summed."""
        n = mask.to(loss.dtype).sum()
        if self.mesh is not None:
            n = psum(n, self.mesh.axis_name)
        for k, v in (("loss", loss * n), *metrics.items()):
            if k not in totals:
                totals[k] = torch.zeros_like(v)
            totals[k].add_(v)

    def _zeroed(self, mode: str) -> Dict[str, torch.Tensor]:
        totals = self._totals[mode]
        for t in totals.values():
            t.zero_()
        return totals

    @staticmethod
    def _read(totals: Dict[str, torch.Tensor], examples: float
              ) -> Dict[str, float]:
        keys = list(totals)
        values = torch.stack([totals[k] for k in keys]).tolist() \
            if keys else []
        out = {k: v / examples for k, v in zip(keys, values)}
        out["examples"] = examples
        return out

    # ------------------------------------------------------------------
    # One step as one CUDA graph
    def _run(self, key: tuple, body: Callable, inputs: tuple):
        """body(*inputs): eagerly off cuda; on cuda a replay of the graph
        captured under `key`, whose first call runs body eagerly on the
        side stream (the warm-up, this call's own step) and then captures
        it."""
        if not self.graphed:
            if key[0] != "train":
                return body(*inputs)
            with profiling.annotate("ag.trainer.eager_step"):
                return body(*inputs)
        g = self.graphs.get(key)
        if g is None:
            with profiling.annotate("ag.trainer.capture"):
                return self._warm_up_and_capture(key, body, inputs)
        with profiling.annotate("ag.trainer.replay"):
            for static, x in zip(g.inputs, inputs):
                static.copy_(x)
            g.graph.replay()
            launches.add(g.counts)
        return g.outputs

    def _warm_up_and_capture(self, key: tuple, body: Callable,
                             inputs: tuple):
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = body(*inputs)
        current.wait_stream(self._side)
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       for x in inputs)
        graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        # thread_local: the prefetch thread may pin and copy meanwhile
        with torch.cuda.graph(graph, stream=self._side,
                              capture_error_mode="thread_local"):
            outputs = body(*static)
        counts = launches.since(before)
        launches.restore(before)         # a capture launches nothing
        self.graphs[key] = _Graph(graph, static, outputs, counts)
        return out

    def _train_body(self, *batch):
        loss, metrics = self._step(batch, ragged=False)
        self._accumulate(self._totals["train"], loss, metrics, batch[-1])
        return loss

    @torch.no_grad()
    def _eval_body(self, *batch):
        outputs = self._outputs(batch)
        with self._global():
            loss, metrics = self.eval_compute_loss(outputs, batch)
        self._accumulate(self._totals["eval"], loss, metrics, batch[-1])
        return outputs, batch[1:-1]

    @staticmethod
    def _resident(loader, body: Callable) -> Callable:
        """body over the batch gathered from the loader's resident data by
        an index row: the gather is part of the captured step."""
        return lambda idx, mask: body(*loader._gather(idx), mask)

    def _train_batch(self, batch: Tuple[torch.Tensor, ...],
                     ragged: bool) -> None:
        if (ragged and self.has_bn) or not self.graphed:
            with profiling.annotate("ag.trainer.eager_step"):
                loss, metrics = self._step(batch, ragged)
                self._accumulate(self._totals["train"], loss, metrics,
                                 batch[-1])
        else:
            self._run(("train", _signature(batch), _conv_bn_gate()),
                      self._train_body, batch)
        self.host_step += 1

    # ------------------------------------------------------------------
    def _prefetched(self, loader, size: int = 2):
        """(n_valid, batch_size, device batch) one batch ahead of the step.

        A ResidentLoader's batches are on the device already
        (`device_iter`). A host loader's are assembled by a background
        thread; on cuda it stages each into pinned memory and issues its
        copy on a side stream, and the step's stream waits on the copy's
        event. The valid counts come from the host masks: no sync."""
        if hasattr(loader, "device_iter") and getattr(loader, "pad_last",
                                                      False):
            yield from loader.device_iter()
            return
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        # over a mesh the valid count and size of the GLOBAL batch: the
        # loader knows them without a collective
        counts = (iter(loader.global_counts()) if self.mesh is not None
                  else None)

        def produce():
            with (torch.cuda.stream(copy_stream) if cuda
                  else contextlib.nullcontext()):
                for batch in loader:
                    mask = np.asarray(batch[-1])
                    n, size = ((float(mask.sum()), mask.shape[0])
                               if counts is None
                               else (float(next(counts)), loader.batch_size))
                    host = [torch.from_numpy(np.ascontiguousarray(b))
                            for b in batch]
                    if not cuda:
                        yield n, size, host, None
                        continue
                    dev = tuple(t.pin_memory().to(self.device,
                                                  non_blocking=True)
                                for t in host)
                    copied = torch.cuda.Event()
                    copied.record(copy_stream)
                    yield n, size, dev, copied

        current = torch.cuda.current_stream(self.device) if cuda else None
        queued = pipeline(produce(), size)
        while True:
            with profiling.annotate("ag.trainer.wait_batch"):
                item = next(queued, None)
            if item is None:
                break
            n, bsize, dev, copied = item
            if cuda:
                current.wait_event(copied)
                for t in dev:
                    t.record_stream(current)
            yield n, bsize, tuple(dev)

    def _use_epoch_scan(self, loader) -> bool:
        if getattr(loader, "mesh", None) is not self.mesh:
            # the loader's and the trainer's placement must agree
            raise ValueError(
                "the loader's mesh is not the trainer's: over a data mesh "
                "each rank needs a loader of its own block of every batch "
                "(DataLoader / ResidentLoader with the trainer's mesh)")
        return (hasattr(loader, "epoch_arrays")
                and getattr(loader, "pad_last", False)
                and getattr(loader, "epoch_scan", True))

    def _finish_train(self, totals, examples: float) -> Dict[str, float]:
        out = self._read(totals, examples)
        if not np.isfinite(out["loss"]):
            # surface divergence at the epoch boundary instead of silently
            # training on NaNs
            raise FloatingPointError(
                f"non-finite training loss {out['loss']} at step "
                f"{self.host_step}; check lr/dtype policy")
        return out

    def train_epoch(self, loader: Iterable[Batch]) -> Dict[str, float]:
        """One pass over the loader's (images, ..., mask) batches."""
        if self._use_epoch_scan(loader):
            return self._train_epoch_resident(loader)
        self.model.train()
        totals = self._zeroed("train")
        examples = 0.0
        for n, bsize, batch in self._prefetched(loader):
            self._train_batch(batch, ragged=n < bsize)
            examples += n
        return self._finish_train(totals, examples)

    def _train_epoch_resident(self, loader) -> Dict[str, float]:
        """The epoch from the loader's index and mask matrices: a replay a
        batch with no host sync until the totals' read at the end. A
        BatchNorm model's ragged tail runs its masked step eagerly, as the
        JAX trainer runs it outside its scan."""
        self.model.train()
        totals = self._zeroed("train")
        idx_all, mask_all, valid = loader.epoch_arrays()
        nb = len(valid)
        ragged_tail = self.has_bn and nb > 0 and valid[-1] < loader.batch_size
        key = ("train", "resident", _signature(loader.data),
               tuple(t.data_ptr() for t in loader.data), loader.batch_size,
               _conv_bn_gate())
        body = self._resident(loader, self._train_body)
        for row in range(nb - ragged_tail):
            self._run(key, body, (idx_all[row], mask_all[row]))
            self.host_step += 1
        if ragged_tail:
            self._train_batch((*loader._gather(idx_all[-1]), mask_all[-1]),
                              ragged=True)
        return self._finish_train(totals, float(sum(valid)))

    @torch.no_grad()
    def eval_epoch(self, loader: Iterable[Batch],
                   collect_outputs: bool = False):
        """Mean loss and metrics (eval_compute_loss) over the valid rows;
        with collect_outputs also [(outputs, non-image batch components)]
        per batch, every tensor of the outputs (a tensor, or nested lists
        and tuples of them, as the multitask and context models return) cut
        to the valid rows, as numpy."""
        self.model.eval()
        totals = self._zeroed("eval")
        if self._use_epoch_scan(loader):
            idx_all, mask_all, valid = loader.epoch_arrays()
            key = ("eval", "resident", _signature(loader.data),
                   tuple(t.data_ptr() for t in loader.data),
                   loader.batch_size)
            body = self._resident(loader, self._eval_body)
            steps = ((k, key, body, (idx_all[row], mask_all[row]))
                     for row, k in enumerate(valid))
        else:
            steps = ((n, ("eval", _signature(batch)), self._eval_body, batch)
                     for n, _, batch in self._prefetched(loader))
        examples = 0.0
        collected = []
        for n, key, body, inputs in steps:
            outputs, rest = self._run(key, body, inputs)
            examples += n
            if collect_outputs:
                # copied out of the graph's buffers before the next replay
                collected.append(self._collect(outputs, rest, inputs[-1],
                                               int(n)))
        out = self._read(totals, examples)
        if not collect_outputs:
            return out
        to_numpy = lambda t: t.cpu().numpy()
        return out, [(_tree(to_numpy, o), _tree(to_numpy, r))
                     for o, r in collected]

    def _collect(self, outputs, rest, mask: torch.Tensor, valid: int):
        """A batch's outputs and non-image components cut to its valid rows;
        over a mesh the ranks' blocks gathered first, in rank order."""
        if self.mesh is None:
            cut = lambda t: t[:valid].clone()
            return _tree(cut, outputs), _tree(cut, rest)
        keep = global_batch_array(mask, self.mesh) > 0
        cut = lambda t: global_batch_array(t, self.mesh)[keep]
        return _tree(cut, outputs), _tree(cut, rest)


# rank r of a mesh seeds its dropout generator with seed + r * this
_RANK_SEED_STRIDE = 1_000_003


# --------------------------------------------------------------------------
# Optimizers with torch-default hyperparameters, as factories over the
# parameters (the JAX package's optax transformations take none)
# --------------------------------------------------------------------------

def adam(lr: float):
    """torch.optim.Adam defaults (betas 0.9/0.999, eps 1e-8) — every
    reference trainer except ContextNet (ref: train_baseline.py:44). On
    cuda `capturable=True, fused=True`: the step count and the bias
    correction stay on the device, so the step can be captured in a CUDA
    graph (the Trainer's graphed step), and one multi-tensor kernel updates
    every parameter (capturable's foreach form launches a kernel a
    parameter for the bias correction, which cost an eager ViT-B/16 step
    ~10 ms of host time on an H100 host); on the CPU the default, host-side
    form."""
    def make(params):
        params = list(params)
        cuda = any(p.is_cuda for p in params)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=cuda, fused=cuda)
    return make


def sgd_momentum(lr: float, momentum: float = 0.9):
    """torch.optim.SGD(momentum=0.9) — ContextNet
    (ref: train_baseline_context.py:49). Its step has no host-side state
    once the momentum buffers exist (after the warm-up step)."""
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum)
