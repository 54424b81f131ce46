"""Content-addressed artifact management (the reference's DVC analog).

The port's own copy of artgraph_tpu/artifacts.py (that module imports no
JAX, but the port imports nothing of the JAX package); the pointer format
and the store's layout are the same, so a pointer written by either
package reads in the other and a blob pushed by one pulls in the other.

The reference versions its 3.7 GB of checkpoints/projections with DVC
pointer files against a Google-Drive remote (ref: .dvc/config:1-4,
checkpoints/with_class_weights.dvc). This module provides the same
workflow without external services:

  track(path)        -> writes <path>.artifact pointer (md5 + size) so the
                        large file stays out of git while its identity is
                        versioned
  push(path, remote) -> copies the blob into a content-addressed store
                        (<remote>/<md5[:2]>/<md5>)
  pull(path, remote) -> restores the file named by its pointer

The remote is any mounted filesystem path (NFS, a FUSE bucket, local disk).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

POINTER_SUFFIX = ".artifact"


def _md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def pointer_path(path: str) -> str:
    return path + POINTER_SUFFIX


def track(path: str) -> str:
    """Hash a file and write its pointer; returns the pointer path."""
    pointer = {
        "md5": _md5(path),
        "size": os.path.getsize(path),
        "path": os.path.basename(path),
    }
    with open(pointer_path(path), "w") as f:
        json.dump(pointer, f, indent=2)
    return pointer_path(path)


def _blob(remote: str, digest: str) -> str:
    return os.path.join(remote, digest[:2], digest)


def _pointer(path: str) -> dict:
    with open(pointer_path(path)) as f:
        return json.load(f)


def push(path: str, remote: str) -> str:
    """Track (if needed) and copy the blob into the remote store."""
    if not os.path.exists(pointer_path(path)):
        track(path)
    blob = _blob(remote, _pointer(path)["md5"])
    if not os.path.exists(blob):
        os.makedirs(os.path.dirname(blob), exist_ok=True)
        shutil.copyfile(path, blob)
    return blob


def pull(path: str, remote: str) -> str:
    """Restore a file from its pointer. Verifies the digest."""
    digest = _pointer(path)["md5"]
    shutil.copyfile(_blob(remote, digest), path)
    if _md5(path) != digest:
        raise IOError(f"artifact digest mismatch for {path}")
    return path


def status(path: str, remote: Optional[str] = None) -> dict:
    """Pointer vs local-file vs remote state summary."""
    out = {"tracked": os.path.exists(pointer_path(path)),
           "local": os.path.exists(path), "in_remote": None, "dirty": None}
    if out["tracked"]:
        digest = _pointer(path)["md5"]
        if out["local"]:
            out["dirty"] = _md5(path) != digest
        if remote:
            out["in_remote"] = os.path.exists(_blob(remote, digest))
    return out
