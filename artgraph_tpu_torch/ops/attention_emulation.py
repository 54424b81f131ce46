"""The attention cores' CUDA source run on the host, against the plain twins.

    python -m artgraph_tpu_torch.ops.attention_emulation [B,N,H ...]

(default: 1,197,2 1,600,1). No GPU and no nvcc: g++ (C++20) compiles
csrc/block_attention.cu, csrc/block_attention_bwd.cu and
csrc/attention_tiles.cuh as host code into build/emulate_attention/, with
the header's PTX helpers (cp.async, ldmatrix, mma.sync) replaced by the
warp-cooperative host versions of csrc/emulation/ptx_emulation.h and CUDA's
built-ins by csrc/emulation/cuda_shim/. Each block runs as 128 host
threads, one block after another, so small shapes take seconds. For each
shape the kernels of the four entry points (strided and packed forward,
saved-o and recomputed-o backward) run on seeded bf16 inputs, and it prints
their max abs error against the plain twins and the worst error over the
card's tolerance (atol + rtol |ref|, both 3e-2), and exits non-zero past
it. It checks the kernels' indexing, fragment layouts, masks and phases;
not their speed, and not what only nvcc or the card can reject. The port
never calls it; tests/test_torch_emulated_attention.py does.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from artgraph_tpu_torch.ops import attention as A

CSRC = Path(__file__).resolve().with_name("csrc")
HERE = CSRC / "emulation"
OUT = Path(__file__).resolve().parents[2] / "build" / "emulate_attention"
TOL = 3e-2


def build(out: Path = OUT) -> ctypes.CDLL:
    """Patch the sources into `out`, compile them and load the library."""
    out.mkdir(parents=True, exist_ok=True)
    header = (CSRC / "attention_tiles.cuh").read_text()
    start = header.index("__device__ __forceinline__ uint32_t smem_addr")
    stop = header.index("// bf16(lo) in the low half")
    (out / "attention_tiles.cuh").write_text(
        header[:start] + (HERE / "ptx_emulation.h").read_text()
        + header[stop:])
    for name, launcher in (("block_attention.cu", "template <bool STRIDED>"),
                           ("block_attention_bwd.cu",
                            "template <bool SAVED_O>")):
        src = (CSRC / name).read_text()
        # the kernels only: cut the launchers and the C entry points
        (out / name).write_text(
            src[:src.index(launcher + "\nint launch(")] + "}  // namespace\n")
    lib = out / "libemulate.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-fno-strict-aliasing",
                    "-shared", "-fPIC", "-pthread", "-I",
                    str(HERE / "cuda_shim"), "-I", str(out), "-include",
                    "cuda_runtime.h", "-o", str(lib),
                    str(HERE / "harness.cpp")], check=True)
    handle = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    handle.emu_attention.argtypes = (I, P, P, P, P) + (I,) * 7 + (F,)
    handle.emu_attention_bwd.argtypes = (I,) + (P,) * 9 + (I,) * 11 + (F,)
    return handle


def errors(ours: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (ours.float() - ref.float()).abs()
    return (err.max().item(),
            (err / (TOL + TOL * ref.float().abs())).max().item())


def check(lib: ctypes.CDLL, B: int, N: int, H: int) -> float:
    """Every kernel at one shape; returns the worst error over tolerance."""
    D, C = 64, 64 * H
    scale = D ** -0.5
    rng = np.random.default_rng(N)
    bf = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    qkv, do = bf(B, N, 3, H, D), bf(B, N, H, D)
    q, k, v = qkv.unbind(2)                         # strided views
    results = {}

    o = torch.full((B, N, H, D), float("nan"), dtype=torch.bfloat16)
    lib.emu_attention(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), B, N, H, 3 * C, 3 * C, 3 * C, C, scale)
    results["strided forward"] = (o, A.fused_attention_plain(q, k, v))
    grads = [torch.full_like(o, float("nan")) for _ in range(3)]
    stats = torch.empty((3, B, H, N))
    ts = (q, k, v, o, do, *grads)
    lib.emu_attention_bwd(1, *(t.data_ptr() for t in ts), stats.data_ptr(),
                          B, N, H, *(t.stride(1) for t in ts), scale)
    for name, a, r in zip(("dq", "dk", "dv"), grads,
                          A.fused_attention_bwd_plain(q, k, v, o, do)):
        results[f"saved-o backward {name}"] = (a, r)

    packed = qkv.reshape(B * N, 3 * C)
    heads = [t.transpose(1, 2) for t in (q, k, v)]          # [B, H, N, D]
    p, of = A.core_plain(*heads, scale)
    ref = of.to(torch.bfloat16).transpose(1, 2).reshape(B * N, C)
    out = torch.full((B * N, C), float("nan"), dtype=torch.bfloat16)
    base = packed.data_ptr()
    lib.emu_attention(0, base, base + 2 * C, base + 4 * C, out.data_ptr(), B,
                      N, H, 3 * C, 3 * C, 3 * C, C, scale)
    results["packed forward"] = (out, ref)
    dout = do.reshape(B * N, C)
    dqkv = torch.full_like(packed, float("nan"))
    g = dqkv.data_ptr()
    lib.emu_attention_bwd(0, base, base + 2 * C, base + 4 * C, None,
                          dout.data_ptr(), g, g + 2 * C, g + 4 * C,
                          stats.data_ptr(), B, N, H, 3 * C, 3 * C, 3 * C, 0,
                          C, 3 * C, 3 * C, 3 * C, scale)
    ref = A.core_bwd_plain(*heads, p, of, do.transpose(1, 2), scale)
    ref = torch.stack(ref).to(torch.bfloat16).permute(1, 3, 0, 2, 4) \
        .reshape(B * N, 3 * C)
    results["packed backward dqkv"] = (dqkv, ref)

    worst = 0.0
    for name, (a, r) in results.items():
        max_abs, ratio = errors(a, r)
        if not torch.isfinite(a.float()).all():
            ratio = float("inf")
        worst = max(worst, ratio)
        print(f"B={B} N={N} H={H} {name}: max abs {max_abs:.4g}, worst "
              f"err/(atol+rtol|ref|) {ratio:.4g}", flush=True)
    return worst


def main(shapes: list[str]) -> int:
    lib = build()
    worst = max(check(lib, *map(int, s.split(","))) for s in shapes)
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["1,197,2", "1,600,1"]))
