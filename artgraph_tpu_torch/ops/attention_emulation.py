"""The port's CUDA kernels' source run on the host, against the plain twins:
the attention cores, the conv + BN-statistics unit, the LayerNorm
backward and column sums of the transformer blocks' backward, and the CSR
scalar sum.

    python -m artgraph_tpu_torch.ops.attention_emulation [B,N,H ...]

(default: 1,197,2 1,600,1; then the unit at two shapes each way, the
LayerNorm backward and a column sum at two shapes each, and the scalar
sum on hubs and on short segments). No GPU and no nvcc: g++ (C++20)
compiles csrc/block_attention.cu, csrc/block_attention_bwd.cu,
csrc/conv_bn.cu, csrc/block_norm_bwd.cu, csrc/csr_segment.cu and
the headers they include as host code into build/emulate_attention/, with
the PTX helpers of
csrc/ptx_helpers.cuh (cp.async, ldmatrix, mma.sync, dynamic shared memory)
replaced by the warp-cooperative host versions of
csrc/emulation/ptx_emulation.h and CUDA's built-ins by
csrc/emulation/cuda_shim/. Each block runs as one host thread per CUDA
thread, one block after another, so small shapes take seconds. For each
attention shape the kernels of the four entry points (strided and packed
forward, saved-o and recomputed-o backward) run on seeded bf16 inputs; for
each unit shape the forward and backward launches of conv_bn.cu (the three
products and the fixed-order sums) run as `ag_conv_bn_{fwd,bwd}_bf16` runs
them, block_norm_bwd.cu's launches as `ag_layernorm_bwd_bf16` and
`ag_colsum_bf16` run them (norm_sequence, colsum_sequence, with the row
splits of ops/attention.py) and csr_segment.cu's two passes as
`ag_csr_scalar_sum_f32` runs them over a CSR's plan (scalar_sequence). It
prints their max abs error against the plain twins and the worst error
over the card's tolerance (bf16 outputs: atol + rtol |ref|, both 3e-2; f32
sums and dw: relative L2 over 2e-2; the scalar sum against its twin in f64
at CSR_ATOL + CSR_RTOL |ref|), and exits non-zero past it. It checks the
kernels' indexing, fragment layouts, masks and phases; not their speed,
and not what only nvcc or the card can reject.
The block GEMM (csrc/block_gemm.cu: wgmma fed by TMA and mbarriers) has no
host version: those instructions act on shared memory and barriers behind
the threads' backs, so only the card checks it (tests/test_torch_cuda.py,
chip_smoke.py). The port never calls this module;
tests/test_torch_emulated_{attention,conv_bn,norm,csr}.py do.
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
GRAD_REL_L2 = 2e-2
CSR_RTOL, CSR_ATOL = 1e-4, 1e-3


def _kernels_only(src: str, marker: str) -> str:
    """A source up to its host-side launches, its anonymous namespace
    closed."""
    return src[:src.index(marker)] + "}  // namespace\n"


def build(out: Path = OUT) -> ctypes.CDLL:
    """Patch the sources into `out`, compile them and load the library."""
    out.mkdir(parents=True, exist_ok=True)
    header = (CSRC / "ptx_helpers.cuh").read_text()
    start = header.index("// A kernel's dynamic shared memory")
    stop = header.index("// bf16(lo) in the low half")
    (out / "ptx_helpers.cuh").write_text(
        header[:start] + (HERE / "ptx_emulation.h").read_text()
        + header[stop:])
    (out / "attention_tiles.cuh").write_text(
        (CSRC / "attention_tiles.cuh").read_text())
    for name, launcher in (("block_attention.cu", "template <bool STRIDED>"),
                           ("block_attention_bwd.cu",
                            "template <bool SAVED_O>")):
        (out / name).write_text(_kernels_only(
            (CSRC / name).read_text(), launcher + "\nint launch("))
    (out / "conv_bn.cu").write_text(_kernels_only(
        (CSRC / "conv_bn.cu").read_text(), "// Host side: launches."))
    (out / "block_norm_bwd.cu").write_text(_kernels_only(
        (CSRC / "block_norm_bwd.cu").read_text(), "// Host side: launches."))
    (out / "csr_segment.cu").write_text(_kernels_only(
        (CSRC / "csr_segment.cu").read_text(), "// Host side: launches."))
    (out / "sum_groups.cuh").write_text(_kernels_only(
        (CSRC / "sum_groups.cuh").read_text(),
        "// Launches the pass on stream s"))
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
    handle.emu_conv_bn_fwd.argtypes = (P,) * 8 + (I,) * 4
    handle.emu_conv_bn_bwd.argtypes = (P,) * 16 + (I,) * 8
    handle.emu_layernorm_bwd.argtypes = (P,) * 7 + (I, I, F, I, I)
    handle.emu_colsum.argtypes = (P,) * 3 + (I,) * 4
    handle.emu_csr_scalar_sum.argtypes = (P, P, I, I, P, P, I)
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


def check_conv_bn(lib: ctypes.CDLL, M: int, K: int, N: int,
                  prologue: bool, chunk: int | None = None,
                  dz_chunk: int | None = None) -> float:
    """The unit's forward and backward launches at one shape against the
    plain twins; the weight gradient's M split into chunks of `chunk` rows
    and the input gradient's N into chunks of `dz_chunk` columns (the
    wrapper's `dw_split` and `dz_split` by default). Returns the worst error
    over tolerance."""
    from artgraph_tpu_torch.ops import conv_bn as U

    rng = np.random.default_rng(M + K + N + prologue)
    f32 = lambda *shape, s=1.0: torch.from_numpy(
        (s * rng.normal(size=shape)).astype(np.float32))
    x = f32(M, K).to(torch.bfloat16)
    a = (1.0 + f32(K, s=0.5)).to(torch.bfloat16)
    b = f32(K, s=0.1).to(torch.bfloat16)
    w = f32(N, K, s=K ** -0.5).to(torch.bfloat16)
    dy = f32(M, N).to(torch.bfloat16)
    ds1, ds2 = f32(N, s=0.1), f32(N, s=0.01)
    chunk, splits = ((chunk, -(-M // chunk)) if chunk
                     else U.dw_split(M, N, K))
    dz_chunk, dz_splits = ((dz_chunk, -(-N // dz_chunk)) if dz_chunk
                           else U.dz_split(M, N, K))
    nan = lambda *shape, dt=torch.float32: torch.full(shape, float("nan"),
                                                      dtype=dt)
    y, s1, s2 = nan(M, N, dt=torch.bfloat16), nan(N), nan(N)
    part = nan(-(-M // U.ROW_TILE), 2 * max(N, K))
    lib.emu_conv_bn_fwd(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                        w.data_ptr(), y.data_ptr(), part.data_ptr(),
                        s1.data_ptr(), s2.data_ptr(), M, K, N, int(prologue))
    dyt, dx = nan(M, N, dt=torch.bfloat16), nan(M, K, dt=torch.bfloat16)
    da, db, dw = nan(K), nan(K), nan(N, K)
    dz_part, dw_part = nan(dz_splits, M, K), nan(splits, N, K)
    lib.emu_conv_bn_bwd(*(t.data_ptr() for t in (
        x, a, b, w, y, dy, ds1, ds2, dyt, dx, part, da, db, dz_part, dw_part,
        dw)), M, K, N, int(prologue), chunk, splits, dz_chunk, dz_splits)
    # the twins return da, db, dw in the dtypes of a, b, w: f32 copies
    fa, fb, fw = a.float(), b.float(), w.float()
    ref = (*U.conv1x1_bn_stats_plain(x, fa, fb, fw, prologue),
           *U.conv1x1_bn_stats_bwd_plain(x, fa, fb, fw, y, dy, ds1, ds2,
                                         prologue))
    worst = 0.0
    for name, ours, r in zip(("y", "s1", "s2", "dx", "da", "db", "dw"),
                             (y, s1, s2, dx, da, db, dw), ref):
        max_abs = (ours.double() - r.double()).abs().max().item()
        if name in ("y", "dx"):
            ratio = errors(ours, r)[1]
            held = "worst err/(atol+rtol|ref|)"
        elif not prologue and name in ("da", "db"):
            ratio = float("inf") if ours.abs().max() > 0 else 0.0
            held = "zero without the prologue"
        else:
            ratio = ((ours.double() - r.double()).norm()
                     / r.double().norm()).item() / GRAD_REL_L2
            held = f"rel L2 / {GRAD_REL_L2}"
        if not torch.isfinite(ours.float()).all():
            ratio = float("inf")
        worst = max(worst, ratio)
        print(f"M={M} K={K} N={N} prologue={prologue} chunks dw={splits} "
              f"dz={dz_splits} {name}: max abs {max_abs:.4g}, {held} "
              f"{ratio:.4g}", flush=True)
    return worst


def _rel_l2(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 distance in f64, over GRAD_REL_L2 (inf where ours is not
    finite)."""
    if not torch.isfinite(ours).all():
        return float("inf")
    a, r = ours.double(), ref.double()
    return ((a - r).norm() / r.norm()).item() / GRAD_REL_L2


def check_norm(lib: ctypes.CDLL, rows: int, cols: int,
               eps: float = 1e-6) -> float:
    """`ag_layernorm_bwd_bf16`'s launches at one shape, twice, against
    `ln_bwd_plain`: dx at rtol = atol = 3e-2, dgamma, dbeta and db_res at
    relative L2 <= GRAD_REL_L2, the second call bit-identical to the first.
    Returns the worst error over tolerance."""
    rng = np.random.default_rng(rows * 4099 + cols)
    f32 = lambda *shape, s=1.0, m=0.0: torch.from_numpy(
        (m + s * rng.normal(size=shape)).astype(np.float32))
    x = f32(rows, cols, s=2.0, m=0.5).to(torch.bfloat16)
    gamma, dy = f32(cols, s=0.1, m=1.0), f32(rows, cols)
    dres = f32(rows, cols).to(torch.bfloat16)
    per, groups = A.norm_groups(rows)

    def run():
        dx = torch.full((rows, cols), float("nan"), dtype=torch.bfloat16)
        part = torch.full((groups, 3 * cols), float("nan"))
        out = torch.full((3, cols), float("nan"))
        lib.emu_layernorm_bwd(x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                              dres.data_ptr(), dx.data_ptr(), part.data_ptr(),
                              out.data_ptr(), rows, cols, eps, per, groups)
        return dx, *out

    ours, again = run(), run()
    ref = A.ln_bwd_plain(x, gamma, dy, dres, eps)
    worst = 0.0 if all(torch.equal(a, b) for a, b in zip(ours, again)) \
        else float("inf")
    for name, a, r in zip(("dx", "dgamma", "dbeta", "db_res"), ours, ref):
        max_abs = (a.double() - r.double()).abs().max().item()
        if name == "dx":
            ratio = errors(a, r)[1] if torch.isfinite(a.float()).all() \
                else float("inf")
            held = "worst err/(atol+rtol|ref|)"
        else:
            ratio, held = _rel_l2(a, r), f"rel L2 / {GRAD_REL_L2}"
        worst = max(worst, ratio)
        print(f"layernorm bwd rows={rows} C={cols} ({groups} blocks of "
              f"{per} rows) {name}: max abs {max_abs:.4g}, {held} "
              f"{ratio:.4g}", flush=True)
    return worst


def check_colsum(lib: ctypes.CDLL, rows: int, cols: int) -> float:
    """`ag_colsum_bf16`'s launches at one shape, twice, against the f32
    column sum of the same tensor at relative L2 <= GRAD_REL_L2, the second
    call bit-identical to the first. Returns the error over tolerance."""
    rng = np.random.default_rng(rows * 7919 + cols)
    t = torch.from_numpy((0.1 + rng.normal(size=(rows, cols)))
                         .astype(np.float32)).to(torch.bfloat16)
    per, chunks = A.colsum_groups(rows, cols)

    def run():
        part = torch.full((chunks, cols), float("nan"))
        out = torch.full((cols,), float("nan"))
        lib.emu_colsum(t.data_ptr(), part.data_ptr(), out.data_ptr(), rows,
                       cols, per, chunks)
        return out

    ours, again = run(), run()
    ratio = _rel_l2(ours, t.float().sum(0))
    if not torch.equal(ours, again):
        ratio = float("inf")
    print(f"colsum rows={rows} C={cols} ({chunks} chunks of {per} rows): "
          f"rel L2 / {GRAD_REL_L2} {ratio:.4g}", flush=True)
    return ratio


def csr_from_counts(counts):
    """The metadata (on the CPU) of segments of `counts` edges each."""
    from artgraph_tpu_torch.ops import csr_segment as T

    counts = np.asarray(counts, np.int64)
    return T._csr_from_sorted(np.repeat(np.arange(counts.size), counts),
                              counts.size, "cpu")


def check_csr_scalar(lib: ctypes.CDLL, counts, lanes: int | None = None
                     ) -> float:
    """`ag_csr_scalar_sum_f32`'s two passes over the plan of segments of
    `counts` edges, in groups of `lanes` lanes (the CSR's own width by
    default), twice, against `scalar_segment_sum_plain` in f64: the worst
    error over CSR_ATOL + CSR_RTOL |ref| (inf unless the second call is
    bit-identical to the first)."""
    from artgraph_tpu_torch.ops import csr_segment as T

    csr = csr_from_counts(counts)
    lanes = lanes or csr.scalar_lanes
    rng = np.random.default_rng(len(counts) * 7 + csr.num_edges)
    w = torch.from_numpy(rng.normal(size=csr.num_edges).astype(np.float32))

    def run():
        out = torch.full((csr.num_segments,), float("nan"))
        scratch = torch.full((csr.num_slots,), float("nan"))
        lib.emu_csr_scalar_sum(w.data_ptr(), csr.plan.data_ptr(),
                               csr.num_chunks, csr.num_merge,
                               scratch.data_ptr(), out.data_ptr(), lanes)
        return out

    ours, again = run(), run()
    ref = T.scalar_segment_sum_plain(w.double(), csr)
    err = (ours.double() - ref).abs()
    ratio = (err / (CSR_ATOL + CSR_RTOL * ref.abs())).max().item() \
        if ref.numel() else 0.0
    if not (torch.isfinite(ours).all() and torch.equal(ours, again)):
        ratio = float("inf")
    print(f"csr scalar sum S={csr.num_segments} E={csr.num_edges} "
          f"({csr.num_chunks} chunks, {csr.num_merge} hubs, {lanes} lanes a "
          f"chunk): max abs {err.max().item() if err.numel() else 0.0:.4g},"
          f" worst err/(atol+rtol|ref|) {ratio:.4g}", flush=True)
    return ratio


def main(shapes: list[str]) -> int:
    lib = build()
    worst = max(check(lib, *map(int, s.split(","))) for s in shapes)
    for M, K, N, prologue, chunk, dz_chunk in (
            (300, 96, 96, True, 96, 32), (130, 32, 160, False, None, None)):
        worst = max(worst, check_conv_bn(lib, M, K, N, prologue, chunk,
                                         dz_chunk))
    for rows, cols in ((300, 768), (17, 192)):
        worst = max(worst, check_norm(lib, rows, cols),
                    check_colsum(lib, rows, 4 * cols))
    for counts in ([0, 1, 255, 256, 257, 31250, 0], [10] * 500):
        worst = max(worst, check_csr_scalar(lib, counts))
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["1,197,2", "1,600,1"]))
