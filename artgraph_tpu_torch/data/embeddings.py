"""Embedding matrices in the reference's .pt format (a torch-saved f32
tensor, ref: train_gnn_embeddings.py:91-92), or .npy.

Port of artgraph_tpu/data/embeddings.py.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def load_embedding(path: str) -> np.ndarray:
    """A 2-D float32 embedding matrix from .pt or .npy."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        tensor = torch.load(path, map_location="cpu", weights_only=False)
        arr = (tensor.detach().numpy() if hasattr(tensor, "detach")
               else np.asarray(tensor))
    return np.ascontiguousarray(arr, dtype=np.float32)


def save_embedding(path: str, array) -> None:
    """Save an embedding matrix (numpy or a tensor on any device); .pt keeps
    the reference format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(array, torch.Tensor):
        array = array.detach().to("cpu", torch.float32).numpy()
    array = np.ascontiguousarray(array, dtype=np.float32)
    if path.endswith(".npy"):
        np.save(path, array)
    else:
        torch.save(torch.from_numpy(array.copy()), path)
