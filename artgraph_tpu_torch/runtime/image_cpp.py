"""ctypes bindings of the native decode and resize library (csrc/artdata.cpp).

Port of artgraph_tpu/runtime/image_cpp.py, with the same entry points and
the same contract: each returns None (`decode_batch_native`: a nonzero
per-item status) where the library is unavailable or a file is not a JPEG
that libjpeg decodes to RGB, and the caller then decodes with PIL
(data/transforms.py). The resize is bit-exact with PIL's bilinear resize by
construction; the decode is bit-exact with PIL where the system libjpeg
agrees with Pillow's.

The library is built at first use, once per process and source:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall csrc/artdata.cpp \\
        -o build/artgraph_tpu_torch/libartdata-<hash>.so \\
        -shared -ljpeg -lpthread

`<hash>` covers the source, the flags and the CPU that built it
(`-march=native` ties the binary to that CPU), so an edited source is
rebuilt and a library from another machine is never loaded. Nothing is
committed. Setting ARTGRAPH_NO_NATIVE (the JAX package's switch) turns the
native path off. An unavailable library is never silent: the first call
logs why once, with the tail of the compiler's stderr, `native_available()`
is False and `native_reason()` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "artdata.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "artgraph_tpu_torch")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-ljpeg", "-lpthread")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "artdata_decode_resize": ((ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                               ctypes.c_int, _U8P), ctypes.c_int),
    "artdata_resize": ((_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _U8P), ctypes.c_int),
    "artdata_decode_batch": ((ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
                              ctypes.POINTER(ctypes.c_int)), ctypes.c_int),
}

log = logging.getLogger(__name__)


def _cpu_model() -> str:
    """What `-march=native` reads: the CPU's model name and feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
    except OSError:
        return ""
    return "".join(lines[:2])


class NativeLibrary:
    """The library of one build directory: built and loaded at the first
    call of `load()`, once (a failure is remembered); `reason` says why it
    is unavailable. Safe to call from the loader's threads."""

    def __init__(self, build_dir: Path | str = BUILD_DIR):
        self.build_dir = Path(build_dir)
        self.reason: Optional[str] = None
        self.build_seconds = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS + LD_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        h.update(_cpu_model().encode())
        return self.build_dir / f"libartdata-{h.hexdigest()[:16]}.so"

    def _build(self, out: Path) -> Optional[str]:
        """Compile into `out` (atomic: a concurrent process never loads a
        partial library); the failure's reason, or None."""
        self.build_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=self.build_dir) as tmpdir:
            tmp = os.path.join(tmpdir, out.name)
            cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp, *LD_FLAGS]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                return f"{CXX} could not run: {e}"
            if proc.returncode != 0:
                tail = "\n".join(proc.stderr.strip().splitlines()[-6:])
                return f"{CXX} failed (exit {proc.returncode}):\n{tail}"
            os.replace(tmp, out)
        return None

    def load(self) -> Optional[ctypes.CDLL]:
        if self._lib is not None or self.reason is not None:
            return self._lib
        with self._lock:
            if self._lib is not None or self.reason is not None:
                return self._lib
            if os.environ.get("ARTGRAPH_NO_NATIVE"):
                self.reason = "ARTGRAPH_NO_NATIVE is set"
            else:
                self.reason = self._load()
            if self.reason is not None:
                log.warning("native JPEG decode unavailable, PIL decodes "
                            "every image: %s", self.reason)
            return self._lib

    def _load(self) -> Optional[str]:
        out = self.path()
        if not out.exists():
            t0 = time.perf_counter()
            reason = self._build(out)
            if reason is not None:
                return reason
            self.build_seconds = time.perf_counter() - t0
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            return f"could not load {out}: {e}"
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        self._lib = lib
        return None


# the process's library; tests swap in one of their own build directory
LIBRARY = NativeLibrary()


def native_available() -> bool:
    return LIBRARY.load() is not None


def native_reason() -> Optional[str]:
    """None where the library is loaded, else why it is not."""
    LIBRARY.load()
    return LIBRARY.reason


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def decode_resize_native(path: str, size: int) -> Optional[np.ndarray]:
    """Decode and resize one JPEG file to uint8 [size, size, 3]; None if the
    library is unavailable or libjpeg cannot decode the file to RGB."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    out = np.empty((size, size, 3), dtype=np.uint8)
    rc = lib.artdata_decode_resize(data, len(data), size, size, _ptr(out))
    return out if rc == 0 else None


def resize_native(image: np.ndarray, size: int) -> Optional[np.ndarray]:
    """PIL-exact bilinear resize of an RGB uint8 [H, W, 3] array."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"resize_native: expected [H, W, 3], got "
                         f"{image.shape}")
    h, w = image.shape[:2]
    out = np.empty((size, size, 3), dtype=np.uint8)
    rc = lib.artdata_resize(_ptr(image), h, w, size, size, _ptr(out))
    return out if rc == 0 else None


def decode_batch_native(paths: Sequence[str], size: int,
                        threads: int = 4) -> Optional[tuple]:
    """Decode and resize JPEG files on `threads` native threads.

    Returns (batch [n, size, size, 3] uint8, status [n] int32), or None if
    the library is unavailable. status[i] != 0 marks an item that failed
    (2: the file could not be opened; 1: libjpeg could not decode it); the
    caller decodes those rows with PIL.
    """
    lib = LIBRARY.load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    status = np.zeros((n,), dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.artdata_decode_batch(arr, n, size, size, threads, _ptr(out),
                             status.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_int)))
    return out, status
