"""Device-resident dataset loader: each split uploaded once, batches gathered
on the device.

Port of artgraph_tpu/data/resident.py (`ResidentCapacityError`,
`estimate_nbytes`, `ResidentLoader`, its sharded residency). Every
component of the dataset (uint8 NHWC images, f32 embeddings, int32 labels)
is materialized once with the dataset's vectorized `get_batch` over all rows
(which also fills a decoded cache, data/cache.py), moved to the device once,
and each batch is an `index_select` of those tensors: no host-to-device copy
of images per step. Batch order, padding and masks are the host
DataLoader's: the same per-epoch shuffle (`np.random.default_rng((seed,
epoch))`, loader.py `DataLoader._batch_indices`), the ragged last batch
padded (its pad slots gather row 0) and masked.

Capacity: before anything is materialized, one row's bytes times the rows
is held against `budget_frac` of the device's free memory
(`torch.cuda.mem_get_info`); a split that does not fit raises
`ResidentCapacityError`, and the CLIs then keep the host loader for it with
a warning (cli/_common.py make_loaders), as the JAX package does. A 224 px
image is 150,528 bytes: ArtGraph's 17,471-row test split is 2.63 GB and a
100k-row train split 15.1 GB, both within 0.6 of an 80 GB card's free
memory. On the CPU there is no budget.

The Trainer consumes `epoch_arrays()` (the epoch's index and mask matrices,
one upload each, gathers inside its captured step) or, with
`epoch_scan=False`, `device_iter()` (the gathered batches one by one).

Sharded residency (`mesh=`, a parallel.mesh.DataMesh), JAX's: rows are
placed block-cyclically, global row i on rank (i % batch_size) // pb with
pb = batch_size / N, the rank that consumes it in the data-parallel step of
an unshuffled epoch, and each rank holds (and decodes) only its rows,
padded to the ranks' common length. A rank's batches are local gathers of
pb rows. With shuffle=False they are the host loader's blocks; with
shuffle=True each rank shuffles its own rows per epoch with the rng
(seed, epoch, rank) (`_plan_sharded`), which covers every row once an
epoch but is not the host loader's order (a global shuffle would defeat
local residency). The valid counts `epoch_arrays` returns are the global
batch's. The capacity check holds a rank's share against its device.
"""
from __future__ import annotations

import numpy as np
import torch

from artgraph_tpu_torch.parallel.mesh import per_rank


class ResidentCapacityError(RuntimeError):
    """The dataset does not fit the device-memory budget; use the host
    loader instead."""

    def __init__(self, need: int, free: int, budget: int):
        self.need, self.free, self.budget = need, free, budget
        super().__init__(
            f"resident dataset needs ~{need / 1e9:.2f} GB but the device "
            f"memory budget is {budget / 1e9:.2f} GB (free {free / 1e9:.2f} "
            "GB); falling back to the host loader")


def estimate_nbytes(dataset) -> int:
    """Estimated resident footprint: one row's bytes x len(dataset)."""
    row = dataset.get_batch(np.zeros(1, dtype=np.int64))
    return int(sum(np.asarray(c).nbytes for c in row)) * len(dataset)


def _device_budget(device: torch.device, frac: float):
    """(free bytes, budget bytes) of a CUDA device, or (None, None) for a
    device that reports none (the CPU)."""
    if device.type != "cuda":
        return None, None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free), int(frac * free)


class ResidentLoader:
    """The host DataLoader's iterator contract (components..., f32 mask,
    static shapes) with the batches gathered on `device`.

    Args match DataLoader's; `num_workers` is accepted and ignored (there is
    no host work after the upload). `budget_frac` bounds the upload to that
    fraction of the device's free memory; `hbm_budget_bytes` overrides the
    measured budget. `epoch_scan` lets the Trainer run the epoch from
    `epoch_arrays()` (False: the per-batch `device_iter()` stream).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0, seed: int = 1,
                 pad_last: bool = True, budget_frac: float = 0.6,
                 hbm_budget_bytes: int | None = None, epoch_scan: bool = True,
                 device: str | torch.device = "cuda", mesh=None):
        if not hasattr(dataset, "get_batch"):
            raise TypeError(f"{type(dataset).__name__} has no vectorized "
                            "get_batch(); ResidentLoader requires one")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.pad_last = pad_last
        self.epoch_scan = epoch_scan
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.device)
        self.n = len(dataset)
        self._epoch = 0
        D = 1 if mesh is None else mesh.size
        if mesh is not None:
            self._pb, self._D = per_rank(batch_size, mesh), D
            if not pad_last and self.n % batch_size:
                raise ValueError("sharded residency requires pad_last=True "
                                 "when the dataset is ragged")

        # the capacity check comes before the dataset is materialized
        self.nbytes = estimate_nbytes(dataset)
        if hbm_budget_bytes is not None:
            free = budget = int(hbm_budget_bytes)
        else:
            free, budget = _device_budget(self.device, budget_frac)
        if budget is not None and self.nbytes // D > budget:
            raise ResidentCapacityError(self.nbytes // D, free, budget)

        rows = np.arange(self.n, dtype=np.int64)
        if mesh is not None:
            # block-cyclic: global row i -> rank (i % B) // pb; the ranks'
            # stores are padded to a common length
            pb = self._pb
            owner = (rows % batch_size) // pb
            self._n_local = np.bincount(owner, minlength=D)
            n_pad = (int(-(-self._n_local.max() // pb) * pb) if self.n
                     else pb)
            rows = rows[owner == mesh.rank]
        comps = dataset.get_batch(rows)
        if mesh is not None:
            comps = [np.concatenate([c, np.zeros((n_pad - len(rows),
                                                  *c.shape[1:]), c.dtype)])
                     for c in map(np.asarray, comps)]
        self.data = tuple(
            torch.from_numpy(np.ascontiguousarray(c)).to(self.device)
            for c in comps)

    def _gather(self, idx: torch.Tensor) -> tuple:
        """Every component's rows idx (an int64 device tensor)."""
        return tuple(a.index_select(0, idx) for a in self.data)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def _epoch_plan(self):
        """The epoch's schedule on the host: ([n_batches, B] index matrix,
        pad slots 0; the per-batch valid counts)."""
        order = np.arange(self.n)
        if self.shuffle:
            # DataLoader._batch_indices' rng: host and resident epochs agree
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
        stop = self.n - self.n % self.batch_size if self.drop_last else self.n
        B = self.batch_size
        starts = range(0, stop, B)
        idx_all = np.zeros((len(starts), B), dtype=np.int64)
        valid = []
        for row, start in enumerate(starts):
            idx = order[start:start + B]
            idx_all[row, :len(idx)] = idx
            valid.append(len(idx))
        return idx_all, valid

    def epoch_arrays(self):
        """One epoch's schedule on the device, one upload each: (int64
        index matrix [n_batches, B], f32 mask matrix [n_batches, B], the
        host's per-batch valid counts). Advances the shuffle epoch. Needs
        pad_last=True (the masked-batch contract)."""
        if not self.pad_last:
            raise NotImplementedError("epoch_arrays requires pad_last=True")
        self._epoch += 1
        if self.mesh is not None:
            idx_all, mask_all, valid = self._plan_sharded()
            idx_all = idx_all[:, self.mesh.rank]
            mask_all = mask_all[:, self.mesh.rank]
        else:
            idx_all, valid = self._epoch_plan()
            mask_all = (np.arange(self.batch_size)[None, :]
                        < np.asarray(valid)[:, None]).astype(np.float32)
        return (torch.from_numpy(idx_all).to(self.device),
                torch.from_numpy(mask_all).to(self.device), valid)

    def device_iter(self):
        """The epoch as (n_valid, batch_size, device batch) with the mask on
        the device too: the Trainer's per-batch stream, with no host-to-
        device copy but the epoch's index and mask matrices."""
        idx_dev, mask_dev, valid = self.epoch_arrays()
        B = self.batch_size
        for row, k in enumerate(valid):
            yield float(k), B, (*self._gather(idx_dev[row]), mask_dev[row])

    def _plan_sharded(self):
        """The sharded epoch's schedule on the host: ([nb, N, pb] per-rank
        index blocks into each rank's store, [nb, N, pb] f32 masks, the
        global batches' valid counts). JAX's plan: only the last batch can
        be ragged (the ranks' row counts differ by at most pb)."""
        D, pb = self._D, self._pb
        nb = len(self)
        orders = []
        for d in range(D):
            o = np.arange(self._n_local[d])
            if self.shuffle:
                rng = np.random.default_rng((self.seed, self._epoch, d))
                rng.shuffle(o)
            orders.append(o)
        idx_all = np.zeros((nb, D, pb), dtype=np.int64)
        mask_all = np.zeros((nb, D, pb), dtype=np.float32)
        valid = []
        for k in range(nb):
            tot = 0
            for d in range(D):
                sl = orders[d][k * pb:(k + 1) * pb]
                idx_all[k, d, :len(sl)] = sl
                mask_all[k, d, :len(sl)] = 1.0
                tot += len(sl)
            valid.append(tot)
        return idx_all, mask_all, valid

    def __iter__(self):
        """DataLoader's contract: (device components..., numpy f32 mask);
        with pad_last=False no mask, and the ragged last batch ragged. Over
        a mesh, this rank's blocks and their masks."""
        self._epoch += 1
        if self.mesh is not None:
            idx_all, mask_all, _ = self._plan_sharded()
            r = self.mesh.rank
            idx_dev = torch.from_numpy(idx_all[:, r]).to(self.device)
            for row in range(len(idx_all)):
                batch = self._gather(idx_dev[row])
                yield (*batch, mask_all[row, r]) if self.pad_last else batch
            return
        idx_all, valid = self._epoch_plan()
        idx_dev = torch.from_numpy(idx_all).to(self.device)
        B = self.batch_size
        for row, k in enumerate(valid):
            batch = self._gather(idx_dev[row])
            if not self.pad_last:
                yield batch if k == B else tuple(c[:k] for c in batch)
                continue
            mask = np.zeros(B, np.float32)
            mask[:k] = 1.0
            yield (*batch, mask)
