"""Full train states for --resume: one file per state, written atomically.

Port of artgraph_tpu/checkpointing/orbax_io.py. The payload is a dict of
tensors, ints, floats, strings, byte strings and nested dicts and lists of
them (the model's and the optimizer's `state_dict()`, the device
generator's state, the epoch, the early-stopping counters).
`save_checkpoint` moves every tensor to the CPU, `torch.save`s the payload
to `path + ".tmp"` and renames it over `path` (`os.replace`), so a crash
mid-write leaves the previous state whole; `restore_checkpoint` loads it
back with the tensors on `map_location`.

Orbax's format is neither read nor written: the GPU hosts the port runs on
have no orbax, and the two packages' train states (optax and torch.optim
states, JAX and Philox generators) do not map onto each other. The port's
reference `.pt` files (torch_interop.py) are what the two packages share.
"""
from __future__ import annotations

import os

import torch


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: dict) -> int:
    """Write payload to path atomically (tmp file + rename); returns the
    file's size in bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


def restore_checkpoint(path: str, map_location: str | torch.device = "cpu"
                       ) -> dict:
    """The payload save_checkpoint wrote, its tensors on map_location."""
    return torch.load(path, map_location=map_location, weights_only=True)
