"""Build the port's CUDA kernels (ops/csrc/*.cu) at first use and bind them.

Each source compiles in its own `nvcc` process, all started together, and
one more `nvcc` links the objects into one shared library with a plain C
interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   # each
    nvcc -shared -o build/artgraph_tpu_torch/libartgraph_kernels-<hash>.so *.o

The library name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as built. Nothing here includes
PyTorch's headers, which keeps a build to seconds. A failed build or load
raises; there is no fallback.

Each C entry point returns `cudaGetLastError()` after its launches; `check`
raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "artgraph_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "ag_layernorm_bf16": ((_P, _P, _P, _P, _I, _I, _F, _P), _I),
    "ag_gemm_bf16": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "ag_gemm_splits": ((_I, _I, _I, _I), _I),
    "ag_attention_core_bf16": ((_P, _P, _I, _I, _I, _I, _F, _P), _I),
    "ag_attention_core_bwd_bf16": ((_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
                                   _I),
    "ag_window_attention_bf16": ((_P,) * 4 + (_I,) * 5 + (_F, _P), _I),
    "ag_window_attention_bwd_bf16": ((_P,) * 7 + (_I, _P, _P) + (_I,) * 5
                                     + (_F, _P), _I),
    "ag_attention_bf16": ((_P,) * 4 + (_I,) * 8 + (_F, _P), _I),
    "ag_attention_bwd_bf16": ((_P,) * 9 + (_I,) * 12 + (_F, _P), _I),
    "ag_layernorm_bwd_bf16": ((_P,) * 7 + (_I, _I, _F, _I, _I, _P), _I),
    "ag_colsum_bf16": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    "ag_normalize_u8": ((_P, _P, _I, _F, _F, _F, _F, _F, _F, _P), _I),
    "ag_csr_sum_f32": ((_P, _P, _I, _I, _I, _P, _P, _I, _I, _P), _I),
    "ag_csr_weighted_sum_f32": ((_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
                                 _P), _I),
    "ag_csr_softmax_f32": ((_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                            _P), _I),
    "ag_csr_scalar_sum_f32": ((_P, _P, _I, _I, _I, _P, _P, _I, _P), _I),
    "ag_conv_bn_fwd_bf16": ((_P,) * 8 + (_I,) * 4 + (_P,), _I),
    "ag_conv_bn_bwd_bf16": ((_P,) * 16 + (_I,) * 8 + (_P,), _I),
    "ag_bn_stats_bf16": ((_P, _P, _I, _I, _I, _I, _P), _I),
    "ag_bn_finish": ((_P, _P, _I, _I, _P, _F) + (_P,) * 9
                     + (_I, _I, _F, _F, _F, _P), _I),
    "ag_bn_apply_bf16": ((_P,) * 8 + (_I,) * 5 + (_P,), _I),
    "ag_bn_colsum_bf16": ((_P,) * 5 + (_I,) * 4 + (_P,), _I),
    "ag_bn_finish_bwd": ((_P, _P, _I, _I) + (_P,) * 5 + (_F, _P, _P, _P, _I,
                                                         _I, _P), _I),
    "ag_bn_dx_bf16": ((_P,) * 11 + (_I,) * 4 + (_P,), _I),
    "ag_error_string": ((_I,), ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from artgraph_tpu_torch/ops/csrc "
            "at first use and need the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(_sources() + list(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libartgraph_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu unless the hashed library exists; (path, seconds).

    The compilers' output (ptxas register and shared-memory report) is kept
    beside the library as `<name>.log`.
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        logs, failed = [], []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            logs.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(logs[-1])
        if not failed:
            lib_tmp = os.path.join(tmpdir, "lib.so")
            cmd = [nvcc, *LINK_FLAGS, "-o", lib_tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append(logs[-1])
        out.with_suffix(".log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
        # atomic: a concurrent process never loads a partial library
        os.replace(lib_tmp, out)
    return out, time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _lib
    if _lib is None:
        path, _ = build()
        handle = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().ag_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
