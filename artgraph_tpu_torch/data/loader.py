"""Host-side batch loader with static batch shapes.

Port of artgraph_tpu/data/loader.py (DataLoader, prepare_dataloader). A
thread pool decodes batches ahead of consumption (JPEG decode and PIL resize
release the interpreter lock), and every batch has the same shape: the final
ragged batch is padded to `batch_size` and an f32 validity mask is appended,
so a step sees one shape per epoch and the losses and metrics weight rows by
the mask. Batches are numpy arrays; the Trainer moves them to the device,
one batch ahead, through `pipeline`.

Over a data mesh (`mesh=`, parallel/mesh.py) each rank's loader yields its
own contiguous block of `batch_size / N` rows of every global batch (JAX's
`P("data")` layout; the global order is the one-device loader's), padded
and masked to that size, and decodes only those rows: the last batch's
padding falls to the last ranks, and a rank whose block is all padding
decodes one row and zeroes it. `global_counts()` gives each global batch's
valid count, which the Trainer reads instead of a collective.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np


def _collate(items) -> Tuple[np.ndarray, ...]:
    """Stack dataset items into batch arrays; int and list/tuple components
    (label pairs) become int32 arrays."""
    first = items[0]
    out = []
    for pos in range(len(first)):
        comps = [item[pos] for item in items]
        if isinstance(first[pos], (list, tuple, int, np.integer)):
            out.append(np.asarray(comps, dtype=np.int32))
        else:
            out.append(np.stack(comps))
    return tuple(out)


def _pad_batch(batch: Tuple[np.ndarray, ...], batch_size: int):
    """Pad every component to `batch_size` rows; return (padded, mask)."""
    n = batch[0].shape[0]
    mask = np.zeros((batch_size,), dtype=np.float32)
    mask[:n] = 1.0
    if n == batch_size:
        return batch, mask
    padded = []
    for comp in batch:
        pad_width = [(0, batch_size - n)] + [(0, 0)] * (comp.ndim - 1)
        padded.append(np.pad(comp, pad_width))
    return tuple(padded), mask


class DataLoader:
    """Iterable over (batch_components..., mask) tuples with static shapes.

    Args mirror the reference loader kwargs (batch_size, shuffle, drop_last,
    num_workers); `seed` drives a per-epoch deterministic shuffle, the same
    order as the JAX package's loader for the same seed and epoch. `mesh`:
    this rank's blocks of the global batches of `batch_size` rows.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 6, seed: int = 1,
                 mesh=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.mesh = mesh
        self._epoch = 0
        self._rows = batch_size
        if mesh is not None:
            from artgraph_tpu_torch.parallel.mesh import per_rank
            self._rows = per_rank(batch_size, mesh)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield order[start:start + self.batch_size]

    def global_counts(self) -> list:
        """Each global batch's valid row count (the shuffle moves rows, not
        counts)."""
        n = len(self.dataset)
        stop = n - n % self.batch_size if self.drop_last else n
        return [min(self.batch_size, stop - s)
                for s in range(0, stop, self.batch_size)]

    def _local(self, indices: np.ndarray):
        """This rank's block of a global batch's indices, and whether it
        holds none (then one row stands in, zeroed by _finalize)."""
        if self.mesh is None:
            return indices, False
        lo = self.mesh.rank * self._rows
        block = indices[lo:lo + self._rows]
        return (block, False) if len(block) else (indices[:1], True)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        self._epoch += 1
        get_batch = getattr(self.dataset, "get_batch", None)

        def fetch(indices):
            if get_batch is not None:
                return tuple(np.asarray(c) for c in get_batch(indices))
            return _collate([self.dataset[int(i)] for i in indices])

        executor = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            # a window of in-flight batches keeps the workers ahead
            window = self.num_workers + 2
            pending = []
            for indices in self._batch_indices():
                block, empty = self._local(indices)
                pending.append((executor.submit(fetch, block), empty))
                if len(pending) >= window:
                    fut, empty = pending.pop(0)
                    yield self._finalize(fut.result(), empty)
            for fut, empty in pending:
                yield self._finalize(fut.result(), empty)
        finally:
            # an abandoned iterator must not leave queued decodes running
            executor.shutdown(wait=False, cancel_futures=True)

    def _finalize(self, batch, empty: bool = False):
        if empty:
            batch = tuple(np.zeros((0, *c.shape[1:]), c.dtype) for c in batch)
        padded, mask = _pad_batch(batch, self._rows)
        return (*padded, mask)


def prepare_dataloader(datasets: Dict[str, object], batch_size: int,
                       shuffle: bool = False, drop_last: bool = False,
                       num_workers: int = 6, seed: int = 1, mesh=None
                       ) -> Dict[str, DataLoader]:
    """One loader per named split (ref: src/utils.py:225-236)."""
    return {name: DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                             drop_last=drop_last, num_workers=num_workers,
                             seed=seed, mesh=mesh)
            for name, ds in datasets.items()}


def pipeline(iterator, size: int = 2):
    """Run `iterator` in a background thread, up to `size` items ahead of
    the consumer (port of the JAX package's `pipeline`): whatever work each
    item takes (batch assembly, a copy to the device) overlaps the
    consumer's. An exception in the thread is raised to the consumer; a
    consumer that stops early stops the thread and waits for it."""
    q: queue.Queue = queue.Queue(maxsize=size)
    done, stop, err = object(), threading.Event(), []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:   # raised again in the consumer
            err.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        thread.join()
