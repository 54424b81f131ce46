"""The data mesh of the port: one process a rank, torch.distributed under it.

Port of artgraph_tpu/parallel/mesh.py. JAX runs one process over N devices
and shards each batch over the mesh's `data` axis; PyTorch's idiom is one
process per device. So here:

  * `distributed_init(coordinator, num_processes, process_id)` is
    `init_process_group` over a `tcp://` or `file://` address: a no-op
    without a coordinator, and when the group is up already;
  * `create_mesh` builds a `DataMesh` (axis `"data"`, its size = the world
    size, this process's rank, its device, backend and process group) and
    makes it the mesh that `axis_name="data"` names in the collectives
    below, as a shard_map axis name does in JAX;
  * `batch_sharding` cuts this rank's contiguous block out of a global
    batch (`P("data")`'s layout), and `global_batch_array` gathers the
    ranks' blocks back into the global batch, in rank order;
  * `replicated` / `shard_params` broadcast a module's parameters and
    buffers, or a tensor, from rank 0 (`P()`);
  * `psum` is a differentiable sum all-reduce: its backward sums the
    cotangents over the ranks, as JAX's transpose of psum does under
    shard_map's check_vma=False. `pmax` is a max all-reduce of a detached
    tensor (JAX's pmax has no differentiation rule either);
  * `sync_grads` is the trainers' `pmean` of the parameter gradients.

The gradient convention is JAX's (artgraph_tpu/train/trainer.py
`_shard_step_math`): every rank computes the same global loss (a psum'd
numerator over a psum'd denominator, or a loss of tensors that every rank
holds whole), so its backward through the psums leaves on each rank N times
its own share of the gradient; `sync_grads` sums those over the ranks and
divides by N, which gives the global gradient with N cancelled exactly (a
division by a power of two for 2 and 4 ranks).

`spawn(fn, world, backend, ...)` starts `world` ranks with the spawn start
method, each in a process of its own that initializes the group over a
`file://` address and calls fn(mesh, *args). The CLIs' `--data_parallel N`
and the tests use it. Each rank owns `cuda:rank` under NCCL, or the CPU (or
one shared card) under gloo. Tensor parallelism (`shard_params(rules=)`) is
not ported.
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

AXIS = "data"

_CURRENT: Optional["DataMesh"] = None


@dataclasses.dataclass
class DataMesh:
    """The ranks of one process group along the `data` axis."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None   # None: the default group
    axis_name: str = AXIS

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


def create_mesh(data: Optional[int] = None,
                device: Optional[torch.device] = None) -> DataMesh:
    """The `data` mesh over the initialized process group (all its ranks;
    `data`, when given, must equal the world size). Without a group, a
    one-rank mesh whose collectives are identities is not built: call
    distributed_init first. The mesh becomes the one `axis_name="data"`
    names."""
    global _CURRENT
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: no process group; call "
                           "distributed_init (or spawn) first")
    world = dist.get_world_size()
    if data is not None and data != world:
        raise ValueError(f"mesh data={data} != world size {world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    _CURRENT = DataMesh(size=world, rank=dist.get_rank(),
                        device=torch.device(device), backend=backend)
    return _CURRENT


def current_mesh() -> Optional[DataMesh]:
    return _CURRENT


def axis_mesh(axis_name: str) -> DataMesh:
    """The mesh an axis name refers to (the current one)."""
    if _CURRENT is None or _CURRENT.axis_name != axis_name:
        raise RuntimeError(f"no mesh with axis {axis_name!r}: collectives "
                           f"over an axis run inside create_mesh's ranks")
    return _CURRENT


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


def global_batch_array(local: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The ranks' blocks concatenated in rank order (the global batch);
    every rank gets it. Under gloo a card's tensors go through the host."""
    src = local.detach().contiguous()
    if mesh.gather_on_host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(local.device)


@torch.no_grad()
def replicated(obj, mesh: DataMesh):
    """Rank 0's values on every rank: a module's parameters and buffers in
    place (returns the module), or a tensor (returns the broadcast copy)."""
    if isinstance(obj, torch.nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
        return obj
    out = obj.detach().clone().contiguous()
    dist.broadcast(out, src=0, group=mesh.group)
    return out


def shard_params(module: torch.nn.Module, mesh: DataMesh, rules=None):
    """Place a model on the mesh: replicated (pure data parallelism). The
    JAX `rules=` (tensor-parallel PartitionSpecs) is not ported."""
    if rules is not None:
        raise NotImplementedError("shard_params(rules=...): tensor "
                                  "parallelism is not ported (ROADMAP.md)")
    return replicated(module, mesh)


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
        mesh = create_mesh(world, device)
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

