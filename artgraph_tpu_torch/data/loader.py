"""Host-side batch loader with static batch shapes.

Port of artgraph_tpu/data/loader.py (DataLoader, prepare_dataloader). A
thread pool decodes batches ahead of consumption (JPEG decode and PIL resize
release the interpreter lock), and every batch has the same shape: the final
ragged batch is padded to `batch_size` and an f32 validity mask is appended,
so a step sees one shape per epoch and the losses and metrics weight rows by
the mask. Batches are numpy arrays; the Trainer moves them to the device,
one batch ahead, through `pipeline`.
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
    order as the JAX package's loader for the same seed and epoch.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 6, seed: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self._epoch = 0

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
                pending.append(executor.submit(fetch, indices))
                if len(pending) >= window:
                    yield self._finalize(pending.pop(0).result())
            for fut in pending:
                yield self._finalize(fut.result())
        finally:
            # an abandoned iterator must not leave queued decodes running
            executor.shutdown(wait=False, cancel_futures=True)

    def _finalize(self, batch):
        padded, mask = _pad_batch(batch, self.batch_size)
        return (*padded, mask)


def prepare_dataloader(datasets: Dict[str, object], batch_size: int,
                       shuffle: bool = False, drop_last: bool = False,
                       num_workers: int = 6, seed: int = 1
                       ) -> Dict[str, DataLoader]:
    """One loader per named split (ref: src/utils.py:225-236)."""
    return {name: DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                             drop_last=drop_last, num_workers=num_workers,
                             seed=seed)
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
