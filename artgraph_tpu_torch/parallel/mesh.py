"""The mesh of the port: one process a rank, torch.distributed under it.

Port of artgraph_tpu/parallel/mesh.py. JAX runs one process over N devices
and shards each batch over the mesh's `data` axis and, for tensor
parallelism, parameters over its `model` axis; PyTorch's idiom is one
process per device. So here:

  * `distributed_init(coordinator, num_processes, process_id)` is
    `init_process_group` over a `tcp://` or `file://` address: a no-op
    without a coordinator, and when the group is up already;
  * `create_mesh(data, model)` lays the world's ranks out as JAX's
    row-major `reshape(data, model)`: rank r sits at (d, m) =
    divmod(r, model). It returns a `DataMesh` of the `data` axis (its
    size, this rank's coordinate d, the subgroup of the ranks that share
    m) whose `model` field holds the `model` axis (size, m, the subgroup
    of the ranks that share d) when model > 1, and makes it the mesh that
    `axis_name="data"` and `"model"` name in the collectives below, as
    shard_map axis names do in JAX. With model=1 no subgroup is made:
    the `data` axis is the whole default group;
  * `batch_sharding` cuts block d out of a global batch (`P("data")`'s
    layout), and `global_batch_array` gathers the blocks of an axis back,
    in coordinate order;
  * `replicated` broadcasts a module's parameters and buffers, or a
    tensor, from rank 0 (`P()`); `shard_params(module, mesh, rules)`
    places each tensor by its spec over the `model` axis (below), and
    `gather_params` reassembles the whole state_dict;
  * `psum` is a differentiable sum all-reduce: its backward sums the
    cotangents over the ranks, as JAX's transpose of psum does under
    shard_map's check_vma=False. `pmax` is a max all-reduce of a detached
    tensor (JAX's pmax has no differentiation rule either);
  * `sync_grads` is the trainers' `pmean` of the parameter gradients over
    the `data` axis.

The gradient convention is JAX's (artgraph_tpu/train/trainer.py
`_shard_step_math`): every rank computes the same global loss (a psum'd
numerator over a psum'd denominator, or a loss of tensors that every rank
holds whole), so its backward through the psums leaves on each rank N times
its own share of the gradient; `sync_grads` sums those over the ranks and
divides by N, which gives the global gradient with N cancelled exactly (a
division by a power of two for 2 and 4 ranks).

Tensor parallelism (`shard_params(module, mesh, rules)`): `rules(name,
tensor)` gives each parameter and buffer a spec in torch's layout, a tuple
of `"model"` or None a dimension (None or () replicates). The JAX rules
(artgraph_tpu/parallel/mesh.py:shard_params) map by layout: a flax Dense
kernel is [in, out] and nn.Linear's weight [out, in], so the kernel's
`P(None, "model")` is the weight's `("model", None)`; a bias `P("model")`
is `("model",)`. A split tensor keeps this rank's contiguous block m of the
dimension; the `model` axis must divide it. The split the port computes
with is a Linear's output dimension (its weight and bias together): that
Linear becomes a `ColumnParallelLinear`, which keeps the model's own
forward code, the state_dict keys and the parameters' names; any other
split raises. The ranks of one `model` subgroup see the same rows, so they
compute the same loss; the step's reductions (the loss's psum, the
BatchNorm moments, `sync_grads`) run over `data` only, where the ranks
share m and so hold the same shards.

`spawn(fn, world, backend, ...)` starts `world` ranks with the spawn start
method, each in a process of its own that initializes the group over a
`file://` address and calls fn(mesh, *args) with a `data` mesh of the whole
world. The CLIs' `--data_parallel N` and the tests use it. Each rank owns
`cuda:rank` under NCCL, or the CPU (or one shared card) under gloo.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

AXIS = "data"
MODEL_AXIS = "model"

_CURRENT: Optional["DataMesh"] = None


@dataclasses.dataclass
class DataMesh:
    """The ranks along one mesh axis (`data` unless named otherwise): its
    size, this rank's coordinate on it and the group of the ranks that
    differ only in it. A `data` mesh of a two-axis layout holds the `model`
    axis in `model` (None: the `model` axis has size 1)."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None   # None: the default group
    axis_name: str = AXIS
    model: Optional["DataMesh"] = None

    @property
    def gather_on_host(self) -> bool:
        """gloo all-gathers CPU tensors only."""
        return self.backend == "gloo" and self.device.type != "cpu"


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo",
                     device: Optional[torch.device] = None,
                     timeout_s: float = 600.0) -> None:
    """init_process_group at `coordinator` (`tcp://host:port` or
    `file:///path`) as rank process_id of num_processes. A no-op without a
    coordinator (one process) or when this process's group is up already."""
    if not coordinator or dist.is_initialized():
        return
    kw = {}
    if backend == "nccl" and device is not None:
        kw["device_id"] = device   # the communicator binds this card now
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def create_mesh(data: Optional[int] = None, model: int = 1,
                device: Optional[torch.device] = None) -> DataMesh:
    """The `data` x `model` mesh over the initialized process group (all
    its ranks; data defaults to world // model, and data * model must be
    the world size): rank r at (d, m) = divmod(r, model), JAX's row-major
    layout. Returns the `data` axis (size data, coordinate d), whose
    `model` field is the `model` axis when model > 1; every rank builds
    every subgroup, in the same order. Without a group, a one-rank mesh
    whose collectives are identities is not built: call distributed_init
    first. The mesh becomes the one the axis names name."""
    global _CURRENT
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: no process group; call "
                           "distributed_init (or spawn) first")
    if not isinstance(model, int) or model < 1:
        raise TypeError(f"create_mesh: model must be a positive int, got "
                        f"{model!r} (pass the device by keyword)")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh data={data} x model={model} != world size "
                         f"{world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    d, m = divmod(dist.get_rank(), model)
    data_group = model_axis = None
    if model > 1:
        for col in range(model):
            group = dist.new_group([row * model + col
                                    for row in range(data)])
            if col == m:
                data_group = group
        for row in range(data):
            group = dist.new_group([row * model + col
                                    for col in range(model)])
            if row == d:
                model_axis = DataMesh(size=model, rank=m, device=device,
                                      backend=backend, group=group,
                                      axis_name=MODEL_AXIS)
    _CURRENT = DataMesh(size=data, rank=d, device=device, backend=backend,
                        group=data_group, model=model_axis)
    return _CURRENT


def current_mesh() -> Optional[DataMesh]:
    return _CURRENT


def axis_mesh(axis_name: str) -> DataMesh:
    """The axis of the current mesh that an axis name refers to."""
    mesh = _CURRENT
    if mesh is not None and mesh.model is not None \
            and mesh.model.axis_name == axis_name:
        return mesh.model
    if mesh is None or mesh.axis_name != axis_name:
        raise RuntimeError(f"no mesh with axis {axis_name!r}: collectives "
                           f"over an axis run inside create_mesh's ranks "
                           f"(a `model` axis needs create_mesh(model > 1))")
    return mesh


def release_mesh() -> None:
    """Forget the current mesh and destroy the process group."""
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def per_rank(batch_size: int, mesh: DataMesh) -> int:
    """Rows of each rank's block of a global batch; raises unless the mesh
    size divides batch_size (JAX: a P("data") batch must divide evenly)."""
    if batch_size % mesh.size:
        raise ValueError(f"--batch {batch_size} is not divisible by the "
                         f"data axis size {mesh.size}")
    return batch_size // mesh.size


def batch_sharding(mesh: DataMesh, batch: Sequence) -> tuple:
    """This rank's contiguous block of every component of a global batch."""
    pb = per_rank(len(batch[0]), mesh)
    lo = mesh.rank * pb
    return tuple(b[lo:lo + pb] for b in batch)


def global_batch_array(local: torch.Tensor, mesh: DataMesh,
                       dim: int = 0) -> torch.Tensor:
    """The blocks of the ranks of `mesh`'s axis concatenated along `dim` in
    coordinate order (the global batch for the `data` axis); every rank
    gets it. Under gloo a card's tensors go through the host."""
    src = local.detach().contiguous()
    if mesh.gather_on_host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim).to(local.device)


@torch.no_grad()
def replicated(obj, mesh: DataMesh):
    """Rank 0's values on every rank: a module's parameters and buffers in
    place (returns the module), or a tensor (returns the broadcast copy).
    A ColumnParallelLinear's blocks come from coordinate 0 of this rank's
    `data` subgroup (rank m), which holds the same block."""
    if isinstance(obj, torch.nn.Module):
        split = {id(t) for mod in obj.modules()
                 if isinstance(mod, ColumnParallelLinear)
                 for t in mod.parameters()}
        for t in list(obj.parameters()) + list(obj.buffers()):
            if id(t) in split:
                dist.broadcast(t.data, src=mesh.model.rank, group=mesh.group)
            else:
                dist.broadcast(t.data, src=0)
        return obj
    out = obj.detach().clone().contiguous()
    dist.broadcast(out, src=0)
    return out


def _spec(name: str, t: torch.Tensor, spec, model_size: int) -> tuple:
    """A rule's spec for `name` checked against the tensor and the `model`
    axis: () when replicated."""
    spec = tuple(spec or ())
    if not spec or all(s is None for s in spec):
        return ()
    if len(spec) != t.dim() or any(s not in (None, MODEL_AXIS)
                                   for s in spec):
        raise ValueError(f"shard_params: {name} {tuple(t.shape)} got spec "
                         f"{spec}; a spec has one entry a dimension, "
                         f"{MODEL_AXIS!r} or None")
    for dim, s in enumerate(spec):
        if s is not None and t.shape[dim] % model_size:
            raise ValueError(f"shard_params: dimension {dim} of {name} "
                             f"{tuple(t.shape)} is not divisible by the "
                             f"model axis size {model_size}")
    return spec


def shard_params(module: torch.nn.Module, mesh: DataMesh, rules=None):
    """Place a model on the mesh in place and return it: with rules=None
    replicated (pure data parallelism), else each parameter and buffer by
    rules(name, tensor) (module docstring): rank 0's values everywhere,
    then each Linear split on its output dimension over `model` swapped for
    a ColumnParallelLinear holding this rank's blocks. Raises ValueError on
    a spec the tensor or the axis does not fit, NotImplementedError on a
    split other than a Linear's output dimension."""
    if rules is None:
        return replicated(module, mesh)
    model_size = 1 if mesh.model is None else mesh.model.size
    named = {**dict(module.named_parameters()),
             **dict(module.named_buffers())}
    specs = {name: _spec(name, t, rules(name, t), model_size)
             for name, t in named.items()}
    columns = {}
    for name, spec in specs.items():
        if not spec:
            continue
        owner, _, leaf = name.rpartition(".")
        linear = module.get_submodule(owner)
        if not (isinstance(linear, torch.nn.Linear)
                and spec == ((MODEL_AXIS, None) if leaf == "weight"
                             else (MODEL_AXIS,))):
            raise NotImplementedError(
                f"shard_params: {name} split {spec}; the port splits a "
                f"Linear's output dimension only (weight ('model', None) "
                f"with its bias ('model',))")
        columns.setdefault(owner, set()).add(leaf)
    for owner, leaves in columns.items():
        want = {"weight"} | ({"bias"} if module.get_submodule(owner).bias
                             is not None else set())
        if leaves != want:
            raise NotImplementedError(
                f"shard_params: {owner}: its weight and bias split "
                f"together, got {sorted(leaves)}")
    replicated(module, mesh)
    if model_size == 1:
        return module
    for owner in columns:
        parent, _, child = owner.rpartition(".")
        parent = module.get_submodule(parent)
        setattr(parent, child, ColumnParallelLinear(
            getattr(parent, child), mesh.model))
    return module


@torch.no_grad()
def gather_params(module: torch.nn.Module, mesh: DataMesh) -> dict:
    """The module's state_dict with every split tensor whole (the model
    axis's blocks gathered in order), under the reference keys: what one
    process would save. A collective: every rank calls it."""
    columns = {name for name, mod in module.named_modules()
               if isinstance(mod, ColumnParallelLinear)}
    out = {}
    for key, t in module.state_dict().items():
        if key.rpartition(".")[0] in columns:
            t = global_batch_array(t, mesh.model, 0)
        out[key] = t
    return out


class _CopyToAxis(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents over the axis
    (each rank holds the part of an input's gradient that its block of the
    output gives)."""

    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis_name), None


class _GatherAxis(torch.autograd.Function):
    """The axis's blocks of the last dimension concatenated in coordinate
    order; the backward keeps this rank's block of the cotangent (every
    rank of the axis holds the same loss)."""

    @staticmethod
    def forward(ctx, y, axis_name):
        axis = axis_mesh(axis_name)
        ctx.lo, ctx.k = axis.rank * y.shape[-1], y.shape[-1]
        return global_batch_array(y, axis, y.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.lo, ctx.k).contiguous(), None


class ColumnParallelLinear(torch.nn.Module):
    """A Linear split on its output dimension over a mesh axis: `weight`
    [out / M, in] and `bias` [out / M] are this rank's block m of the
    Linear's rows; forward(x) is the whole Linear's output on every rank
    (the blocks' outputs gathered), so the model around it is unchanged.
    The parameter names and state_dict keys are the Linear's."""

    def __init__(self, linear: torch.nn.Linear, axis: DataMesh):
        super().__init__()
        k = linear.out_features // axis.size
        rows = slice(axis.rank * k, (axis.rank + 1) * k)
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        self.axis_name = axis.axis_name
        self.weight = torch.nn.Parameter(linear.weight.detach()[rows].clone(),
                                         linear.weight.requires_grad)
        self.bias = None if linear.bias is None else torch.nn.Parameter(
            linear.bias.detach()[rows].clone(), linear.bias.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToAxis.apply(x, self.axis_name)
        return _GatherAxis.apply(F.linear(x, self.weight, self.bias),
                                 self.axis_name)


# ---------------------------------------------------------------------------
# Collectives over an axis name
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    """A sum all-reduce whose backward is the same all-reduce of the
    cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.group), None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum over the ranks of `axis_name`; differentiable (the backward sums
    the cotangents over the ranks)."""
    return _PSum.apply(x, axis_mesh(axis_name).group)


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Max over the ranks of `axis_name`, of the detached tensor."""
    mesh = axis_mesh(axis_name)
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out


@torch.no_grad()
def sync_grads(params, mesh: DataMesh) -> None:
    """The pmean of the parameters' gradients, in place: one sum
    all-reduce per dtype over the flattened gradients, divided by the mesh
    size. Every rank has the same set of gradients (the same model and
    graph), so the buckets agree."""
    buckets: dict = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------

def rank_device(rank: int, device: str | torch.device) -> torch.device:
    """A rank's device: `cuda:rank` for a cuda request, the CPU otherwise."""
    device = torch.device(device)
    return torch.device("cuda", rank) if device.type == "cuda" else device


def _rank_main(fn, rank: int, world: int, backend: str, init_file: str,
               device: str, threads: int, args: tuple) -> None:
    """One rank: the group over init_file, the mesh, fn(mesh, *args); its
    return value (rank 0's) or its traceback lands beside init_file."""
    torch.set_num_threads(threads)
    device = torch.device(device)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        distributed_init(f"file://{init_file}", world, rank, backend, device)
        mesh = create_mesh(world, device=device)
        result = fn(mesh, *args)
        if rank == 0:
            with open(f"{init_file}.result", "wb") as f:
                pickle.dump(result, f)
    except BaseException:
        with open(f"{init_file}.rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        release_mesh()


def spawn(fn: Callable, world: int, backend: str = "gloo",
          init_file: Optional[str] = None, timeout: float = 600.0,
          args: tuple = (), device: str | torch.device = "cpu",
          devices: Optional[List[str]] = None,
          threads: Optional[int] = None):
    """Run fn(mesh, *args) in `world` spawned ranks and return rank 0's
    result. fn must be importable by name (a module-level function). Rank r
    runs on devices[r], else rank_device(r, device). init_file is the
    rendezvous file (a fresh temporary one by default; it must not exist).
    The ranks are joined within `timeout` seconds: a rank that fails stops
    the others at once, and a hang is killed; either raises with the failed
    rank's traceback."""
    ctx = mp.get_context("spawn")
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="artgraph_dp_")
        init_file = os.path.join(tmp, "rendezvous")
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    devices = devices or [str(rank_device(r, device)) for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_file, devices[r],
                               threads, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for r, p in enumerate(procs):
            path = f"{init_file}.rank{r}.err"
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            late = time.monotonic() > deadline
            raise RuntimeError(
                (f"data-parallel ranks not done within {timeout} s; "
                 if late else "a data-parallel rank failed; ")
                + "\n".join(errors))
        with open(f"{init_file}.result", "rb") as f:
            return pickle.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

