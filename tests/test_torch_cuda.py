"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; without an NVIDIA GPU every test skips. The module imports
no jax, so it runs on a GPU host without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py imports jax, hence --noconftest there.) Tolerances: the
block kernels' outputs and dx at rtol = atol = 3e-2 in bf16 (they round where
the plain versions round and differ in accumulation order only); their f32
parameter gradients at relative L2 <= GRAD_REL_L2 and max|a-b| / mean|a| <=
GRAD_MAX_REL, well inside the JAX tests' bf16 gradient bound of 0.2
(tests/test_mlp_kernel.py); the K third of db_qkv, zero in exact arithmetic,
by absolute error only; the normalize bit-exact. The f32 plain references
run with TF32 off. The f32 CSR segment kernels against their plain twins in
f64 at rtol = 1e-4, atol = 1e-3 (the hub bound of tests/test_csr_segment.py),
and bit-identical from call to call. The block GEMM (gemm_cuda) in every
built layout/epilogue pair against gemm_plain at the ViT-B/16 sizes and
ragged ones: bf16 at rtol = atol = 3e-2, f32 at relative L2 <= GRAD_REL_L2,
bit-identical on repeat. The conv + BN-statistics unit's y and dx
at rtol = atol = 3e-2, its f32 sums and gradients (s1, s2, da, db, dw) at
relative L2 <= GRAD_REL_L2, bit-identical from call to call. The two
attention ops of the unfused paths (fused_attention on strided q/k/v views,
fused_qkv_attention), forward and backward: bf16 outputs, dq/dk/dv and dx
at rtol = atol = 3e-2, the f32 dw and db at relative L2 <= GRAD_REL_L2 (the
K third of db by absolute error, as above), bit-identical from call to call,
at N up to 600 (the attention cores' shared memory does not grow with N).
The windowed block (Swin-B's four stage shapes at batch 32: N = 144, head dim
32, the relative-position bias, the shift mask) at the block tolerances
above, its f32 dBias as a parameter gradient, bit-identical on repeat.
"""
import collections

import numpy as np
import pytest
import torch

from artgraph_tpu_torch.ops import (attention, block_attention_bwd_plain,
                                    block_attention_plain, block_gemm,
                                    block_mlp_bwd_plain, block_mlp_plain,
                                    conv_bn, csr_segment,
                                    fused_block_attention, fused_block_mlp,
                                    launches, mlp, normalize_images,
                                    normalize_images_plain)

GRAD_REL_L2 = 2e-2
GRAD_MAX_REL = 0.1
GRAD_NAMES = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
BN_COUNTERS = ("batchnorm_stats", "batchnorm_finish", "batchnorm_apply",
               "batchnorm_colsum", "batchnorm_finish_bwd", "batchnorm_dx")


def zeroed_counts(monkeypatch) -> collections.Counter:
    """The launch counters (ops/launches.py), an empty table for the rest
    of the test."""
    table = collections.Counter()
    monkeypatch.setattr(launches, "COUNTS", table)
    return table


def read(counts, *names) -> tuple:
    return tuple(counts[k] for k in names)


def block_inputs(B, N, C, dense_shapes, seed):
    """x, gamma, beta and (w [in, out], b) pairs as numpy f32, flax layout."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(rng.normal(size=(B, N, C)))
    gamma = f32(1.0 + 0.1 * rng.normal(size=(C,)))
    beta = f32(0.1 * rng.normal(size=(C,)))
    linears = []
    for fan_in, fan_out in dense_shapes:
        linears += [f32(rng.normal(size=(fan_in, fan_out)) / np.sqrt(fan_in)),
                    f32(0.02 * rng.normal(size=(fan_out,)))]
    return x, gamma, beta, linears


def torch_args(x, gamma, beta, linears, dtype):
    """Port layout: x in dtype, f32 params, Linear weights [out, in]."""
    tx = torch.from_numpy(x).to(dtype)
    params = [torch.from_numpy(gamma), torch.from_numpy(beta)]
    for i, a in enumerate(linears):
        params.append(torch.from_numpy(a.T.copy() if i % 2 == 0 else a))
    return tx, params


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain references
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("C,H,Hd", [(128, 2, 512), (192, 3, 320)])
@pytest.mark.parametrize("N", [17, 197, 600])
def test_cuda_block_kernels_match_plain(N, C, H, Hd):
    """(192, 3, 320) leaves partial GEMM tiles along N (576, 320, 192)."""
    _need_cuda()
    B = 3
    for fn, plain, outs, extra in (
            (fused_block_attention, block_attention_plain,
             ((C, 3 * C), (C, C)), (H,)),
            (fused_block_mlp, block_mlp_plain, ((C, Hd), (Hd, C)), ())):
        x, gamma, beta, lin = block_inputs(B, N, C, outs, seed=N)
        tx, params = torch_args(x, gamma, beta, lin, torch.bfloat16)
        tx, params = tx.cuda(), [p.cuda() for p in params]
        ours = fn(tx, *params, *extra)
        torch.cuda.synchronize()
        ref = plain(tx, *params, *extra)
        torch.testing.assert_close(ours.float(), ref.float(), rtol=3e-2,
                                   atol=3e-2)


def check_grads(ours, ref, kind: str, C: int) -> None:
    """dx at rtol = atol = 3e-2, each f32 parameter gradient by relative L2
    and max|a-b| / mean|a|; for the attention block the K third of db_qkv
    (exactly zero in exact arithmetic) by absolute error against the scale
    of the whole db_qkv."""
    torch.testing.assert_close(ours[0].float(), ref[0].float(), rtol=3e-2,
                               atol=3e-2)
    for name, a, r in zip(GRAD_NAMES, ours[1:], ref[1:]):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        a, r = a.double(), r.double()
        if kind == "attention" and name == "db1":
            scale = r.abs().mean()
            k_err = (a[C:2 * C] - r[C:2 * C]).abs().max()
            assert k_err <= GRAD_MAX_REL * scale, (name, float(k_err))
            a, r = torch.cat((a[:C], a[2 * C:])), torch.cat((r[:C], r[2 * C:]))
        rel_l2 = (a - r).norm() / r.norm()
        max_rel = (a - r).abs().max() / r.abs().mean()
        assert rel_l2 <= GRAD_REL_L2 and max_rel <= GRAD_MAX_REL, (
            kind, name, float(rel_l2), float(max_rel))


@pytest.mark.cuda
@pytest.mark.parametrize("C,H,Hd", [(128, 2, 512), (192, 3, 320)])
@pytest.mark.parametrize("N", [17, 197, 600])
def test_cuda_block_bwd_kernels_match_plain(N, C, H, Hd):
    """The backward kernels against the plain backward, B = 3 (K = 3N rows
    in the weight-gradient GEMMs: a ragged tail of the 32-row K step),
    bit-identical on repeat."""
    _need_cuda()
    B = 3
    do = torch.from_numpy(np.random.default_rng(N + C).normal(
        size=(B, N, C)).astype(np.float32)).to("cuda", torch.bfloat16)
    for kind, bwd, plain, outs, extra in (
            ("attention", attention.block_attention_bwd_cuda,
             block_attention_bwd_plain, ((C, 3 * C), (C, C)), (H,)),
            ("mlp", mlp.block_mlp_bwd_cuda, block_mlp_bwd_plain,
             ((C, Hd), (Hd, C)), ())):
        x, gamma, beta, lin = block_inputs(B, N, C, outs, seed=N + 1)
        tx, params = torch_args(x, gamma, beta, lin, torch.bfloat16)
        tx, params = tx.cuda(), [p.cuda() for p in params]
        ours = bwd(tx, *params, do, *extra, 1e-6)
        again = bwd(tx, *params, do, *extra, 1e-6)
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(ours, again)), kind
        ref = plain(tx, *params[:5], do, *extra)
        check_grads(ours, ref, kind, C)


def _rel_l2(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.double(), r.double()
    return ((a - r).norm() / r.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [64, 192, 768])
@pytest.mark.parametrize("rows", [1, 17, 6304, 6305])
def test_cuda_layernorm_bwd_matches_plain(rows, cols):
    """csrc/block_norm_bwd.cu's one-pass LayerNorm backward against
    ln_bwd_plain: dx at rtol = atol = 3e-2, dgamma, dbeta and db_res (the
    column sums of the residual gradient) at relative L2 <= GRAD_REL_L2,
    bit-identical on repeat; rows off the blocks' runs, C off the 256
    columns of a warp's loads."""
    _need_cuda()
    rng = np.random.default_rng(rows + cols)
    dev = lambda a, dt=torch.float32: torch.from_numpy(
        np.asarray(a, np.float32)).to("cuda", dt)
    x = dev(0.5 + 2.0 * rng.normal(size=(rows, cols)), torch.bfloat16)
    gamma = dev(1.0 + 0.1 * rng.normal(size=cols))
    dy = dev(rng.normal(size=(rows, cols)))
    dres = dev(rng.normal(size=(rows, cols)), torch.bfloat16)
    ours = block_gemm.layernorm_bwd_cuda(x, gamma, dy, dres, 1e-6)
    again = block_gemm.layernorm_bwd_cuda(x, gamma, dy, dres, 1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(ours, again))
    ref = block_gemm.ln_bwd_plain(x, gamma, dy, dres, 1e-6)
    assert ours[0].dtype == torch.bfloat16
    torch.testing.assert_close(ours[0].float(), ref[0].float(), rtol=3e-2,
                               atol=3e-2)
    for name, a, r in zip(("dgamma", "dbeta", "db_res"), ours[1:], ref[1:]):
        assert a.dtype == torch.float32 and a.shape == (cols,)
        assert _rel_l2(a, r) <= GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [64, 192, 768])
@pytest.mark.parametrize("rows", [1, 17, 6304, 6305])
def test_cuda_colsum_matches_plain(rows, cols):
    """csrc/block_norm_bwd.cu's column sums against the f32 column sum of
    the same bf16 tensor at relative L2 <= GRAD_REL_L2, bit-identical on
    repeat."""
    _need_cuda()
    t = torch.from_numpy(np.random.default_rng(rows * cols).normal(
        0.1, 1.0, size=(rows, cols)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
    ours, again = block_gemm.colsum_cuda(t), block_gemm.colsum_cuda(t)
    torch.cuda.synchronize()
    assert torch.equal(ours, again)
    assert ours.dtype == torch.float32 and ours.shape == (cols,)
    assert _rel_l2(ours, t.float().sum(0)) <= GRAD_REL_L2


@pytest.mark.cuda
def test_cuda_norm_kernels_raise_on_widths_they_do_not_take():
    """A row wider than NORM_MAX_COLS (held in registers) and rows that are
    not whole 16-byte loads raise before any launch; nothing falls back."""
    _need_cuda()
    z = lambda *shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt,
                                                      device="cuda")
    with pytest.raises(ValueError, match="at most 1024"):
        block_gemm.layernorm_bwd_cuda(z(4, 1032), z(1032, dt=torch.float32),
                                      z(4, 1032, dt=torch.float32),
                                      z(4, 1032), 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        block_gemm.layernorm_bwd_cuda(z(4, 68), z(68, dt=torch.float32),
                                      z(4, 68, dt=torch.float32), z(4, 68),
                                      1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        block_gemm.colsum_cuda(z(4, 68))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_backward_reaches_every_block_parameter(monkeypatch):
    """backward() through both block ops on cuda: each parameter gets a
    finite f32 gradient from the backward kernels, x a bf16 one."""
    _need_cuda()
    counts = zeroed_counts(monkeypatch)
    C, H = 128, 2
    x, gamma, beta, lin = block_inputs(2, 17, C, ((C, 3 * C), (C, C)), seed=3)
    tx, ap = torch_args(x, gamma, beta, lin, torch.bfloat16)
    _, _, _, lin = block_inputs(2, 17, C, ((C, 4 * C), (4 * C, C)), seed=4)
    _, mp = torch_args(x, gamma, beta, lin, torch.bfloat16)
    tx = tx.cuda().requires_grad_()
    ap = [p.cuda().requires_grad_() for p in ap]
    mp = [p.cuda().requires_grad_() for p in mp]
    out = fused_block_mlp(fused_block_attention(tx, *ap, H), *mp)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert read(counts, "fused_block_attention_bwd",
                "fused_block_mlp_bwd") == (1, 1)
    assert tx.grad.dtype == torch.bfloat16
    for p in (*ap, *mp):
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["resnet", "vit"])
def test_cuda_normalize_bit_exact(transform):
    _need_cuda()
    x = torch.randint(0, 256, (3, 224, 224, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0)).cuda()
    ours = normalize_images(x, transform)
    torch.cuda.synchronize()
    assert torch.equal(ours, normalize_images_plain(x, transform))


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["resnet", "vit"])
@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (3, 17, 31, 3)])
def test_cuda_normalize_bit_exact_with_a_tail(shape, transform):
    """105 and 4743 elements: whole 4-byte loads, then a tail of 1 and 3
    elements on the scalar path."""
    _need_cuda()
    x = torch.randint(0, 256, shape, dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1)).cuda()
    ours = normalize_images(x, transform)
    torch.cuda.synchronize()
    assert torch.equal(ours, normalize_images_plain(x, transform))


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_reject_bad_operands(monkeypatch):
    _need_cuda()
    counts = zeroed_counts(monkeypatch)
    C = 128
    x, gamma, beta, lin = block_inputs(2, 9, C, ((C, 3 * C), (C, C)), seed=0)
    tx, params = torch_args(x, gamma, beta, lin, torch.bfloat16)
    tx, params = tx.cuda(), [p.cuda() for p in params]
    fused_block_attention(tx, *params, 2)
    normalize_images(torch.zeros((1, 8, 8, 3), dtype=torch.uint8,
                                 device="cuda"), "vit")
    torch.cuda.synchronize()
    assert read(counts, "fused_block_attention", "fused_block_mlp",
                "normalize_images") == (1, 0, 1)

    with pytest.raises(TypeError):          # x must be bf16
        fused_block_attention(tx.float(), *params, 2)
    with pytest.raises(TypeError):          # params must be f32
        fused_block_attention(tx, *[p.half() for p in params], 2)
    with pytest.raises(ValueError):         # x must be contiguous
        fused_block_attention(tx.transpose(0, 1), *params, 2)
    with pytest.raises(ValueError):         # head dim 128/8 = 16 not built
        fused_block_attention(tx, *params, 8)
    for extra in ({"bias": torch.zeros(2, 9, 9, device="cuda")},
                  {"regions": torch.zeros(1, 9, dtype=torch.int32,
                                          device="cuda")}):
        with pytest.raises(ValueError):     # only D = 32 takes them
            fused_block_attention(tx, *params, 2, **extra)
    with pytest.raises(TypeError):          # images must be uint8
        normalize_images(torch.zeros((1, 8, 8, 3), device="cuda"), "vit")
    assert read(counts, "fused_block_attention",
                "normalize_images") == (1, 1)

    # the block GEMM refuses, before any launch, what its TMA loads and
    # 16-byte stores cannot take: rows not a multiple of 8 elements
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16,
                                    device="cuda")
    bias = torch.zeros(64, device="cuda")
    G = block_gemm
    for a, b, layout, epi in (
            (bf(16, 36), bf(64, 36), G.LAYOUT_NT, G.EPI_BIAS),
            (bf(16, 32), bf(60, 32), G.LAYOUT_NT, G.EPI_BIAS),
            (bf(16, 36), bf(36, 64), G.LAYOUT_NN, G.EPI_NONE),
            (bf(16, 32), bf(32, 60), G.LAYOUT_NN, G.EPI_F32),
            (bf(40, 12), bf(40, 64), G.LAYOUT_TN, G.EPI_F32),
            (bf(40, 16), bf(40, 20), G.LAYOUT_TN, G.EPI_F32)):
        with pytest.raises(ValueError, match="not a shape the kernel takes"):
            G.gemm_cuda(a, b, layout, epi, bias=bias[:b.shape[0]])
    torch.cuda.synchronize()


# every (layout, epilogue) pair csrc/block_gemm.cu builds
GEMM_PAIRS = ([(block_gemm.LAYOUT_NT, e) for e in (
    block_gemm.EPI_BIAS, block_gemm.EPI_BIAS_GELU,
    block_gemm.EPI_BIAS_RESIDUAL, block_gemm.EPI_BIAS_GELU_AUX)]
    + [(block_gemm.LAYOUT_NN, e) for e in (
        block_gemm.EPI_NONE, block_gemm.EPI_F32, block_gemm.EPI_DGELU)]
    + [(block_gemm.LAYOUT_TN, block_gemm.EPI_F32)])


@pytest.mark.cuda
@pytest.mark.parametrize("layout,epilogue", GEMM_PAIRS)
@pytest.mark.parametrize("size", ["vit", "ragged"])
def test_cuda_gemm_matches_plain(layout, epilogue, size):
    """gemm_cuda in each built layout/epilogue pair against gemm_plain at
    the ViT-B/16 sizes (M = 32 x 197 = 6304, ragged against the 128-row
    tile; K = 768, N = 768 or 2304; the weight gradients at K = 6304) and at
    a ragged M = 200 with K = 3072 (TN: a ragged K = 1000, not a whole
    number of k-steps, split in chunks); bf16 at rtol = atol = 3e-2, f32
    at relative L2 <= GRAD_REL_L2; bit-identical on repeat."""
    _need_cuda()
    A = block_gemm
    if layout == A.LAYOUT_TN:
        M, N, K = (768, 2304, 6304) if size == "vit" else (2304, 768, 1000)
    else:
        M, N, K = (6304, 768, 768) if size == "vit" else (200, 2304, 3072)
    rng = np.random.default_rng(M + N + K + 10 * layout + epilogue)
    dev = lambda shape, s=1.0: torch.from_numpy(
        (s * rng.normal(size=shape)).astype(np.float32)).to("cuda",
                                                            torch.bfloat16)
    a = dev((K, M) if layout == A.LAYOUT_TN else (M, K))
    b = dev((N, K) if layout == A.LAYOUT_NT else (K, N),
            1.0 if layout == A.LAYOUT_TN else K ** -0.5)
    bias = (dev((N,), 0.02).float() if epilogue <= A.EPI_BIAS_GELU_AUX
            else None)
    aux = (dev((M, N)) if epilogue in (A.EPI_BIAS_RESIDUAL, A.EPI_DGELU)
           else None)
    run = lambda: A.gemm_cuda(a, b, layout, epilogue, bias=bias, aux=aux)
    ours, again = run(), run()
    torch.cuda.synchronize()
    ref = A.gemm_plain(a, b, layout, epilogue, bias=bias, aux=aux)
    if epilogue != A.EPI_BIAS_GELU_AUX:
        ours, again, ref = (ours,), (again,), (ref,)
    for o, g, r in zip(ours, again, ref):
        assert torch.equal(o, g)
        assert o.dtype == r.dtype and o.shape == r.shape
        if epilogue == A.EPI_F32:
            rel = (o.double() - r.double()).norm() / r.double().norm()
            assert rel <= GRAD_REL_L2, float(rel)
        else:
            torch.testing.assert_close(o.float(), r.float(), rtol=3e-2,
                                       atol=3e-2)


def csr_case(S: int, F: int, seed: int, device: str = "cuda"):
    """Sorted segment ids over 3000 edges into S segments (segment 0 a hub
    of half the edges, some segments empty), f32 rows [E, F], weights and
    logits [E] (one logit +200), and the CSR metadata on `device`."""
    rng = np.random.default_rng(seed)
    E = 3000
    ids = np.sort(np.where(rng.random(E) < 0.5, 0,
                           rng.integers(S // 2, S, E)))
    csr = csr_segment._csr_from_sorted(ids, S, device)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    logits = rng.normal(size=E)
    logits[E // 3] += 200.0
    return (csr, f32(rng.normal(size=(E, F))), f32(rng.random(E)),
            f32(logits))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [128, 32, 18])
def test_cuda_csr_kernels_match_plain(F, monkeypatch):
    """Each CSR kernel against its plain twin in f64 on the same inputs at
    rtol = 1e-4, atol = 1e-3 (the hub bound of tests/test_csr_segment.py),
    bit-identical from call to call, one launch per call."""
    _need_cuda()
    counts = zeroed_counts(monkeypatch)
    csr, data, w, logits = csr_case(100, F, seed=F)
    T = csr_segment
    cases = ((T.segment_sum_cuda, T.segment_sum_plain, (data,)),
             (T.weighted_segment_sum_cuda, T.weighted_segment_sum_plain,
              (data, w)),
             (T.softmax_aggregate_cuda, T.softmax_aggregate_plain,
              (data, logits)),
             (T.scalar_segment_sum_cuda, T.scalar_segment_sum_plain, (w,)))
    for kernel, plain, args in cases:
        ours, again = kernel(*args, csr), kernel(*args, csr)
        torch.cuda.synchronize()
        ref = plain(*[a.double() for a in args], csr)
        ours = ours if isinstance(ours, tuple) else (ours,)
        again = again if isinstance(again, tuple) else (again,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b, r in zip(ours, again, ref):
            assert torch.equal(a, b), kernel.__name__
            torch.testing.assert_close(a.double(), r, rtol=1e-4, atol=1e-3)
    assert read(counts, "csr_segment_sum", "csr_weighted_segment_sum",
                "csr_attention_aggregate",
                "csr_scalar_segment_sum") == (2, 2, 2, 2)
    with pytest.raises(TypeError):          # rows must be f32
        T.segment_sum_cuda(data.double(), csr)
    with pytest.raises(ValueError):         # metadata on another device
        T.segment_sum_cuda(data, csr_case(100, F, seed=F, device="cpu")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [18, 32, 100_000])
def test_cuda_scalar_sum_at_the_benchmark_shapes(S, monkeypatch):
    """The scalar sum over E = 1M edges into the `genre` hubs (S = 18,
    ~55.6K edges each), the `style` hubs (32) and the artworks (100K, ~10
    each: 4 lanes a chunk): within rtol = 1e-4, atol = 1e-3 of the f64
    plain twin, bit-identical on repeat, one launch counted per call."""
    _need_cuda()
    counts = zeroed_counts(monkeypatch)
    rng = np.random.default_rng(S)
    E = 1_000_000
    csr = csr_segment._csr_from_sorted(np.sort(rng.integers(0, S, E)), S,
                                       "cuda")
    assert csr.scalar_lanes == (4 if S == 100_000 else 32)
    w = torch.from_numpy(rng.random(E).astype(np.float32)).cuda()
    ours = csr_segment.scalar_segment_sum_cuda(w, csr)
    again = csr_segment.scalar_segment_sum_cuda(w, csr)
    torch.cuda.synchronize()
    assert torch.equal(ours, again)
    torch.testing.assert_close(
        ours.double(), csr_segment.scalar_segment_sum_plain(w.double(), csr),
        rtol=1e-4, atol=1e-3)
    assert counts["csr_scalar_segment_sum"] == 2


@pytest.mark.cuda
def test_cuda_csr_gradients_match_the_cpu():
    """Gradients through csr_gather (both axes, 2-D and 1-D) and
    csr_attention_aggregate on the card against the plain path on the
    CPU."""
    _need_cuda()
    T = csr_segment
    rng = np.random.default_rng(0)
    n_src, n_dst, E, F = 60, 40, 3000, 32
    ei = np.stack([np.where(rng.random(E) < 0.5, 3, rng.integers(0, n_src, E)),
                   rng.integers(0, n_dst, E)])
    h = rng.normal(size=(n_src, F)).astype(np.float32)
    a = rng.normal(size=(n_dst,)).astype(np.float32)
    att = rng.normal(size=(F,)).astype(np.float32)
    grads = {}
    for device in ("cuda", "cpu"):
        _, ecsr = T.build_edge_csr(ei, n_src, n_dst, device)
        ht, at, attt = (torch.from_numpy(v).to(device).requires_grad_()
                        for v in (h, a, att))
        msgs = T.csr_gather(ht, ecsr, "src")
        logits = torch.nn.functional.leaky_relu(
            msgs @ attt + T.csr_gather(at, ecsr, "dst"), 0.2)
        out = T.csr_attention_aggregate(msgs, logits, ecsr.dst)
        out.square().sum().backward()
        grads[device] = [t.grad.cpu() for t in (ht, at, attt)]
    for g, r in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(98, 64, 64), (1000, 96, 160),
                                   (6272, 256, 64), (1568, 512, 1024)])
@pytest.mark.parametrize("prologue", [False, True])
def test_cuda_conv_bn_unit_matches_plain(M, K, N, prologue, monkeypatch):
    """Both kernels of the unit against the plain twins; M ragged against
    the 128-row tile, N and K not multiples of 128; (6272, 256, 64) splits
    the weight gradient's rows, (1568, 512, 1024) the input gradient's N
    (52 tiles); bit-identical on repeat; one launch a call."""
    _need_cuda()
    counts = zeroed_counts(monkeypatch)
    rng = np.random.default_rng(M + K + N)
    dev = lambda a, dt=torch.float32: torch.from_numpy(
        np.asarray(a, np.float32)).to("cuda", dt)
    x = dev(rng.normal(size=(M, K)), torch.bfloat16)
    a = dev(rng.normal(size=K) * 0.5 + 1.0, torch.bfloat16)
    b = dev(rng.normal(size=K) * 0.1, torch.bfloat16)
    w = dev(rng.normal(size=(N, K)) / np.sqrt(K))
    dy = dev(rng.normal(size=(M, N)), torch.bfloat16)
    ds1, ds2 = dev(rng.normal(size=N) * 0.1), dev(rng.normal(size=N) * 0.01)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, w)]
    out = conv_bn.conv1x1_bn_stats(*leaves, prologue)
    torch.autograd.backward(out, (dy, ds1, ds2))
    fwd = [conv_bn.conv1x1_bn_stats_cuda(x, a, b, w, prologue)
           for _ in range(2)]
    bwd = [conv_bn.conv1x1_bn_stats_bwd_cuda(x, a, b, w, fwd[0][0], dy, ds1,
                                             ds2, prologue)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert read(counts, "conv1x1_bn_stats",
                "conv1x1_bn_stats_bwd") == (1, 1)
    for t, g in zip(leaves, bwd[0]):
        assert torch.equal(t.grad, g)
    ref = conv_bn.conv1x1_bn_stats_plain(x, a, b, w, prologue)
    ref_bwd = conv_bn.conv1x1_bn_stats_bwd_plain(x, a, b, w, fwd[0][0], dy,
                                                 ds1, ds2, prologue)
    for name, ours, again, r in zip(
            ("y", "s1", "s2", "dx", "da", "db", "dw"), (*fwd[0], *bwd[0]),
            (*fwd[1], *bwd[1]), (*ref, *ref_bwd)):
        assert torch.equal(ours, again), name
        assert ours.dtype == r.dtype and ours.shape == r.shape, name
        if name in ("y", "dx"):
            torch.testing.assert_close(ours.float(), r.float(), rtol=3e-2,
                                       atol=3e-2)
        elif not prologue and name in ("da", "db"):
            assert not ours.any(), name
        else:
            rel = (ours.double() - r.double()).norm() / r.double().norm()
            assert rel <= GRAD_REL_L2, (name, float(rel))
    with pytest.raises(TypeError):          # x must be bf16
        conv_bn.conv1x1_bn_stats_cuda(x.float(), a, b, w, prologue)
    with pytest.raises(ValueError):         # K must be a multiple of 32
        conv_bn.conv1x1_bn_stats_cuda(x[:, :K - 16].contiguous(), a[:K - 16],
                                      b[:K - 16], w[:, :K - 16], prologue)


def attention_case(B, N, H, seed):
    """A [B, N, 3, H, 64] bf16 qkv tensor, the output gradient [B, N, H, 64],
    and for the qkv op x [B, N, C], f32 w [3C, C] and b [3C], on the card."""
    rng = np.random.default_rng(seed)
    C = 64 * H
    dev = lambda a, dt=torch.float32: torch.from_numpy(
        np.asarray(a, np.float32)).to("cuda", dt)
    return (dev(rng.normal(size=(B, N, 3, H, 64)), torch.bfloat16),
            dev(rng.normal(size=(B, N, H, 64)), torch.bfloat16),
            dev(rng.normal(size=(B, N, C)), torch.bfloat16),
            dev(rng.normal(size=(3 * C, C)) / np.sqrt(C)),
            dev(0.1 * rng.normal(size=3 * C)))


@pytest.mark.cuda
@pytest.mark.parametrize("N,scale", [(197, None), (64, 0.5), (65, None),
                                     (600, None)])
def test_cuda_attention_kernels_match_plain(N, scale, monkeypatch):
    """The four kernels of fused_attention and fused_qkv_attention against
    their plain twins, q/k/v strided views of one qkv tensor (never copied),
    bit-identical on repeat; the autograd ops count one launch a call."""
    _need_cuda()
    counts = zeroed_counts(monkeypatch)
    B, H = 3, 2
    C = 64 * H
    qkv, do, x, w, b = attention_case(B, N, H, seed=N)
    q, k, v = qkv.unbind(2)
    assert q.stride(1) == 3 * C
    fwd = [attention.fused_attention_cuda(q, k, v, scale) for _ in range(2)]
    bwd = [attention.fused_attention_bwd_cuda(q, k, v, fwd[0], do, scale)
           for _ in range(2)]
    qfwd = [attention.fused_qkv_attention_cuda(x, w, b, H, scale)
            for _ in range(2)]
    dout = do.view(B, N, C)
    qbwd = [attention.fused_qkv_attention_bwd_cuda(x, w, b, qfwd[0], dout, H,
                                                   scale) for _ in range(2)]
    torch.cuda.synchronize()
    for ours, again in ((fwd[0], fwd[1]), *zip(bwd[0], bwd[1]),
                        (qfwd[0], qfwd[1]), *zip(qbwd[0], qbwd[1])):
        assert torch.equal(ours, again)
    checks = [(fwd[0], attention.fused_attention_plain(q, k, v, scale))]
    checks += zip(bwd[0], attention.fused_attention_bwd_plain(
        q, k, v, fwd[0], do, scale))
    checks.append((qfwd[0], attention.fused_qkv_attention_plain(
        x, w, b, H, scale)))
    ref = attention.fused_qkv_attention_bwd_plain(x, w, b, qfwd[0], dout, H,
                                                  scale)
    checks.append((qbwd[0][0], ref[0]))
    for ours, r in checks:
        assert ours.dtype == torch.bfloat16 and ours.shape == r.shape
        torch.testing.assert_close(ours.float(), r.float(), rtol=3e-2,
                                   atol=3e-2)
    dw, db = (t.double() for t in qbwd[0][1:])
    rdw, rdb = (t.double() for t in ref[1:])
    assert qbwd[0][1].dtype == qbwd[0][2].dtype == torch.float32
    assert (dw - rdw).norm() / rdw.norm() <= GRAD_REL_L2
    k_err = (db[C:2 * C] - rdb[C:2 * C]).abs().max()
    assert k_err <= GRAD_MAX_REL * rdb.abs().mean(), float(k_err)
    qv = lambda t: torch.cat((t[:C], t[2 * C:]))
    assert (qv(db) - qv(rdb)).norm() / qv(rdb).norm() <= GRAD_REL_L2

    leaf = qkv.clone().requires_grad_()
    attention.fused_attention(*leaf.unbind(2), scale).backward(do)
    xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))
    attention.fused_qkv_attention(xl, wl, bl, H, scale).backward(dout)
    torch.cuda.synchronize()
    assert torch.equal(leaf.grad, torch.stack(bwd[0], 2))
    for t, g in zip((xl, wl, bl), qbwd[0]):
        assert torch.equal(t.grad, g)
    assert read(counts, "fused_attention", "fused_attention_bwd",
                "fused_qkv_attention",
                "fused_qkv_attention_bwd") == (1, 1, 1, 1)


@pytest.mark.cuda
def test_cuda_attention_ops_raise_rather_than_fall_back():
    """f32 inputs, a head dim other than 64 and a misaligned view raise on
    the card; nothing falls back. N = 600, which a [64, N] score tile in
    shared memory could not hold, runs and matches the twins."""
    _need_cuda()
    qkv, do, x, w, b = attention_case(2, 17, 2, seed=0)
    q, k, v = qkv.unbind(2)
    with pytest.raises(TypeError):                       # f32 q, k, v
        attention.fused_attention_cuda(q.float(), k.float(), v.float())
    with pytest.raises(TypeError):                       # f32 x
        attention.fused_qkv_attention_cuda(x.float(), w, b, 2)
    with pytest.raises(ValueError):                      # D = 32
        attention.fused_attention_cuda(*(t.reshape(2, 17, 4, 32)
                                         for t in (q.contiguous(),) * 3))
    with pytest.raises(ValueError):                      # C / H = 32
        attention.fused_qkv_attention_cuda(x, w, b, 4)
    with pytest.raises(ValueError):                      # 8-byte aligned
        attention.fused_attention_cuda(*(qkv.view(2, 17, -1)[:, :, 4:132]
                                         .reshape(2, 17, 2, 64),) * 3)
    big, bdo, *_ = attention_case(1, 600, 1, seed=1)
    bq = big.unbind(2)
    out = attention.fused_attention_cuda(*bq)
    grads = attention.fused_attention_bwd_cuda(*bq, out, bdo)
    torch.cuda.synchronize()
    refs = (attention.fused_attention_plain(*bq),
            *attention.fused_attention_bwd_plain(*bq, out, bdo))
    for ours, ref in zip((out, *grads), refs):
        torch.testing.assert_close(ours.float(), ref.float(), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.cuda
def test_cuda_attention_modules_reach_every_parameter(monkeypatch):
    """backward() through the standalone Attention (both fuse_qkv) and a
    small ViT(fuse_qkv=False) on the card: every parameter gets a finite
    f32 gradient, through the attention kernels only."""
    _need_cuda()
    from artgraph_tpu_torch.models import ViT, init_random_
    from artgraph_tpu_torch.models.vit import Attention

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 17, 128, generator=gen)
    for fuse_qkv in (True, False):
        mod = init_random_(Attention(128, 2, fuse_qkv=fuse_qkv), gen).cuda()
        mod(x.cuda().to(torch.bfloat16)).float().square().sum().backward()
        torch.cuda.synchronize()
        for name, p in mod.named_parameters():
            assert p.grad is not None and p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
    counts = zeroed_counts(monkeypatch)
    vit = init_random_(ViT(img_size=32, patch_size=16, embed_dim=128,
                           depth=2, num_heads=2, fuse_qkv=False), gen).cuda()
    vit(torch.randn(2, 32, 32, 3, generator=gen).cuda()).square().sum() \
        .backward()
    torch.cuda.synchronize()
    for name, p in vit.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    assert read(counts, "fused_block_attention", "fused_block_attention_bwd",
                "fused_block_mlp", "fused_block_mlp_bwd") == (0, 0, 0, 0)


@pytest.mark.cuda
def test_cuda_fusion_training_step_launches_the_block_kernels(monkeypatch):
    """One Trainer step of NewMultiModalMultiTaskViT on a 2-block trunk on
    the card, with forward_inputs (images, both embeddings) and the 0.5/0.5
    multi-task loss, as train_new_multimodal_multitask runs it: 1 normalize
    and, a block, 1 forward and 1 backward launch of each block kernel;
    the loss and every trained parameter's update finite."""
    _need_cuda()
    import functools

    from artgraph_tpu_torch.cli._common import multi_task_loss
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.models import ViT, heads, init_random_
    from artgraph_tpu_torch.train import Trainer, adam

    monkeypatch.setattr(heads, "ViT", functools.partial(
        ViT, img_size=32, patch_size=16, embed_dim=128, depth=2,
        num_heads=2))
    nc = {"style": 32, "genre": 18}
    model = init_random_(heads.NewMultiModalMultiTaskViT(128, nc),
                         torch.Generator().manual_seed(1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, adam(3e-4), multi_task_loss(None, None, 0.5, 0.5,
                                                         "cuda"),
                      transform_type="vit", device="cuda",
                      forward_inputs=image_and_embeddings)
    rng = np.random.default_rng(2)
    batch = (rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             rng.normal(size=(4, 128)).astype(np.float32),
             rng.normal(size=(4, 128)).astype(np.float32),
             np.stack([rng.integers(0, 32, 4), rng.integers(0, 18, 4)], 1)
             .astype(np.int32), np.ones(4, np.float32))
    counts = zeroed_counts(monkeypatch)
    m = trainer.train_epoch([batch])
    torch.cuda.synchronize()
    assert read(counts, "normalize_images", "fused_block_attention",
                "fused_block_mlp", "fused_block_attention_bwd",
                "fused_block_mlp_bwd") == (1, 2, 2, 2, 2)
    assert np.isfinite(m["loss"]) and set(m) >= {"style_correct",
                                                 "genre_correct"}
    for n, p in model.named_parameters():
        if n.startswith("vit.head."):         # timm's head, never called
            continue
        assert torch.isfinite(p).all() and not torch.equal(
            p.detach().cpu(), before[n]), n


# Swin-B at 384 px, batch 32: (windows, C, heads, windows an image) of its
# four stages, N = 144 tokens a window, head dim 32
SWIN_B_STAGES = [(2048, 128, 4, 64), (512, 256, 8, 16), (128, 512, 16, 4),
                 (32, 1024, 32, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("BW,C,H,nW", SWIN_B_STAGES)
def test_cuda_window_block_matches_plain(BW, C, H, nW):
    """fused_block_attention on one Swin-B stage's windows: the bias, and
    the shift mask (its region ids) where the stage has more than one
    window, through the windowed cores; the forward and every gradient,
    dBias included, against the plain twins, the backward bit-identical on
    repeat; windows over 160 tokens refused."""
    _need_cuda()
    from artgraph_tpu_torch.models.swin import shift_regions

    N, res = 144, 12 * int(nW ** 0.5)
    x, gamma, beta, lin = block_inputs(BW, N, C, ((C, 3 * C), (C, C)),
                                       seed=C)
    tx, params = torch_args(x, gamma, beta, lin, torch.bfloat16)
    tx, params = tx.cuda(), [p.cuda() for p in params]
    rng = np.random.default_rng(C + 1)
    bias = torch.from_numpy(rng.normal(size=(H, N, N)).astype(np.float32)
                            ).cuda()
    mask = shift_regions(res, 12, 6).cuda() if nW > 1 else None
    ours = fused_block_attention(tx, *params, H, 1e-5, bias=bias,
                                 regions=mask)
    torch.cuda.synchronize()
    ref = block_attention_plain(tx, *params, H, 1e-5, bias, mask)
    torch.testing.assert_close(ours.float(), ref.float(), rtol=3e-2,
                               atol=3e-2)
    do = torch.from_numpy(rng.normal(size=(BW, N, C)).astype(np.float32)
                          ).to("cuda", torch.bfloat16)
    grads = attention.block_attention_bwd_cuda(tx, *params, do, H, 1e-5,
                                               bias, mask)
    again = attention.block_attention_bwd_cuda(tx, *params, do, H, 1e-5,
                                               bias, mask)
    torch.cuda.synchronize()
    assert len(grads) == 8
    assert all(torch.equal(a, g) for a, g in zip(grads, again))
    ref = block_attention_bwd_plain(tx, *params[:5], do, H, 1e-5, bias, mask)
    check_grads(grads[:7], ref[:7], "attention", C)
    a, r = grads[7].double(), ref[7].double()
    assert grads[7].dtype == torch.float32 and a.shape == (H, N, N)
    assert (a - r).norm() / r.norm() <= GRAD_REL_L2
    assert (a - r).abs().max() / r.abs().mean() <= GRAD_MAX_REL
    with pytest.raises(ValueError):          # 169 tokens: over 160
        fused_block_attention(torch.zeros(1, 169, C, dtype=torch.bfloat16,
                                          device="cuda"), *params, H, 1e-5,
                              bias=torch.zeros(H, 169, 169, device="cuda"))


@pytest.mark.cuda
def test_cuda_swin_fusion_training_step_launches_the_window_kernels(
        monkeypatch):
    """One Trainer step of NewMultiModalMultiTaskSwin on a two-stage trunk
    (head dim 32, a shifted stage of four windows, a last stage of one) on
    the card: every block's attention through the windowed cores, none
    through ViT's, the MLP kernels a block each way; the loss and every
    trained parameter's update finite, the bias tables' included."""
    _need_cuda()
    import functools

    from artgraph_tpu_torch.cli._common import multi_task_loss
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.models import SwinTransformer, heads, init_random_
    from artgraph_tpu_torch.train import Trainer, adam

    monkeypatch.setattr(heads, "SwinTransformer", functools.partial(
        SwinTransformer, img_size=32, patch_size=4, embed_dim=64,
        depths=(2, 2), num_heads=(2, 4), window_size=4))
    nc = {"style": 32, "genre": 18}
    model = init_random_(heads.NewMultiModalMultiTaskSwin(128, nc),
                         torch.Generator().manual_seed(1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, adam(3e-4), multi_task_loss(None, None, 0.5, 0.5,
                                                         "cuda"),
                      transform_type="swin", device="cuda",
                      forward_inputs=image_and_embeddings)
    rng = np.random.default_rng(2)
    batch = (rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             rng.normal(size=(4, 128)).astype(np.float32),
             rng.normal(size=(4, 128)).astype(np.float32),
             np.stack([rng.integers(0, 32, 4), rng.integers(0, 18, 4)], 1)
             .astype(np.int32), np.ones(4, np.float32))
    counts = zeroed_counts(monkeypatch)
    m = trainer.train_epoch([batch])
    torch.cuda.synchronize()
    assert read(counts, "fused_block_attention", "fused_block_attention_bwd",
                "window_attention_core", "window_attention_core_bwd",
                "fused_block_mlp", "fused_block_mlp_bwd") == (0, 0, 4, 4, 4, 4)
    assert np.isfinite(m["loss"])
    for n, p in model.named_parameters():
        if n.startswith("swin.head."):        # timm's head, never called
            continue
        assert torch.isfinite(p).all() and not torch.equal(
            p.detach().cpu(), before[n]), n


@pytest.mark.cuda
def test_cuda_context_training_step_matches_the_plain_path(monkeypatch):
    """One Trainer step of MultiModalMultiTask (a ResNet50 of stage sizes
    (1, 1, 1, 1) at full widths, bf16, 64x64 images, batch 8, head dropout
    0) on the card with train_baseline_context_multitask's joint loss (the
    0.5/0.5 class loss, MSE, lamb 0.6), the fused unit's gate open: 1
    normalize and 2 forward and 2 backward unit launches a bottleneck; the
    step's loss, logits and graph_proj within relative L2 5e-2 of the same
    step on the plain path (the gate closed: cuDNN and eager BatchNorm, no
    unit launch); every parameter updated and finite on both."""
    _need_cuda()
    import functools

    from artgraph_tpu_torch.cli._common import joint_loss, multi_task_loss
    from artgraph_tpu_torch.models import ResNet50, heads, init_random_
    from artgraph_tpu_torch.train import Trainer, adam, mse

    stages = (1, 1, 1, 1)
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=stages))
    nc = {"style": 32, "genre": 18}
    src = init_random_(heads.MultiModalMultiTask(128, nc),
                       torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    batch = (rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
             rng.normal(size=(8, 128)).astype(np.float32),
             np.stack([rng.integers(0, 32, 8), rng.integers(0, 18, 8)], 1)
             .astype(np.int32), np.ones(8, np.float32))
    train_loss = joint_loss(multi_task_loss(None, None, 0.5, 0.5, "cuda"),
                            mse, 0.6)
    runs = {}
    for gate in (True, False):
        if gate:
            monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
        else:
            monkeypatch.delenv("ARTGRAPH_CONVBN")
        model = heads.MultiModalMultiTask(128, nc)
        model.load_state_dict(src.state_dict())
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        seen = []

        def compute(outputs, b):
            seen.append([t.detach().float().cpu() for t in
                         (*outputs[0], outputs[1])])
            return train_loss(outputs, b)

        trainer = Trainer(model, adam(3e-4), compute, device="cuda")
        counts = zeroed_counts(monkeypatch)
        loss, _ = trainer.train_step(trainer.to_device(batch))
        torch.cuda.synchronize()
        units = 2 * len(stages) if gate else 0
        assert read(counts, "conv1x1_bn_stats", "conv1x1_bn_stats_bwd",
                    "normalize_images") == (units, units, 1), gate
        assert torch.isfinite(loss)
        for n, p in model.named_parameters():
            assert torch.isfinite(p).all() and not torch.equal(
                p.detach().cpu(), src.state_dict()[n]), (gate, n)
        runs[gate] = [loss.double().cpu().reshape(1), *seen[0]]
    for name, ours, plain in zip(("loss", "style", "genre", "graph_proj"),
                                 runs[True], runs[False]):
        rel = (ours.double() - plain.double()).norm() / plain.double().norm()
        assert rel <= 5e-2, (name, float(rel))


@pytest.mark.cuda
def test_cuda_resumed_graphed_epoch_equals_an_uninterrupted_one(tmp_path,
                                                               monkeypatch):
    """--resume on the graphed step, at dropout 0.4: a small ViT trained one
    epoch, its state saved (save_resume_state), restored into a fresh
    trainer (load_resume_state) and trained a second epoch equals two
    uninterrupted epochs bit for bit: the second epoch's loss, every
    parameter and Adam's state. The restart's first batch is an eager
    warm-up where the uninterrupted run replays: both must draw the same
    dropout masks from the restored generator (cuDNN deterministic, for the
    patch embedding's convolution)."""
    import functools

    from artgraph_tpu_torch.cli._common import (load_resume_payload,
                                                load_resume_state,
                                                save_resume_state,
                                                single_task_loss)
    from artgraph_tpu_torch.models import ViT, heads
    from artgraph_tpu_torch.train import EarlyStopping, Trainer, adam

    _need_cuda()
    monkeypatch.setattr(heads, "ViT", functools.partial(
        ViT, img_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
        mlp_ratio=4.0))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(5)
    batches = []
    for i in range(4):
        mask = np.ones(8, np.float32)
        mask[6:] = 0.0 if i == 3 else 1.0
        batches.append((rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
                        rng.integers(0, 5, 8).astype(np.int32), mask))

    def trainer():
        torch.manual_seed(0)
        return Trainer(heads.ViTSingleTask(5, dropout=0.4), adam(1e-3),
                       single_task_loss(None, "cuda"), transform_type="vit",
                       device="cuda", seed=1)

    straight = trainer()
    want = [straight.train_epoch(batches) for _ in range(2)]
    first = trainer()
    got = [first.train_epoch(batches)]
    save_resume_state(str(tmp_path), first, 1, EarlyStopping())
    resumed = trainer()
    assert load_resume_state(str(tmp_path), resumed, EarlyStopping(),
                             load_resume_payload(str(tmp_path))) == 1
    got.append(resumed.train_epoch(batches))
    torch.cuda.synchronize()
    assert got == want and resumed.host_step == straight.host_step == 8
    for (name, p), q in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        assert torch.equal(p, q), name
    for p, q in zip(resumed.model.parameters(), straight.model.parameters()):
        for k, v in resumed.optimizer.state[p].items():
            assert torch.equal(v, straight.optimizer.state[q][k]), k
            assert v.device == p.device, k


def _bn_module(C, seed, device="cuda"):
    """A train-mode MixedBatchNorm with seeded parameters and buffers."""
    from artgraph_tpu_torch.models import MixedBatchNorm

    g = torch.Generator().manual_seed(seed)
    bn = MixedBatchNorm(C)
    bn.weight.data = 1.0 + 0.2 * torch.randn(C, generator=g)
    bn.bias.data = 0.2 * torch.randn(C, generator=g)
    bn.running_mean.data = 0.1 * torch.randn(C, generator=g)
    bn.running_var.data = 1.0 + 0.1 * torch.rand(C, generator=g)
    return bn.to(device).train()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,branches,identity", [
    (32, 112, 112, 64, 1, False), (32, 56, 56, 256, 1, True),
    (32, 7, 7, 2048, 2, False), (3, 5, 7, 96, 2, False)])
def test_cuda_batchnorm_kernels_match_plain(B, H, W, C, branches, identity,
                                            monkeypatch):
    """Each launch of ops/batchnorm.py against its twin on the same CUDA
    inputs, at ResNet50's stem (32x112x112x64), a layer1 tail with the
    identity and layer4's downsample tail (32x7x7x2048), and a ragged
    one: the statistics' and column sums' run partials, added, at relative
    L2 <= 1e-5 of the twins' sums and bit-identical on a second call; the
    finishing (train and eval), apply, backward finishing and dx
    bit-identical to the twins (they round where MixedBatchNorm rounds,
    and the twins' f32 ops on the card are the kernels' own); one launch
    counted a call."""
    from artgraph_tpu_torch.ops import batchnorm as T

    _need_cuda()
    counts = zeroed_counts(monkeypatch)
    rng = np.random.default_rng(B * H + C)
    M = B * H * W
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        "cuda", torch.bfloat16)
    xs = [dev(rng.normal(size=(M, C)) * 2.0 + 0.3) for _ in range(branches)]
    ident = dev(rng.normal(size=(M, C))) if identity else None
    g = dev(rng.normal(size=(M, C)))
    n = float(M)

    def summed(parts, ref, name):
        assert torch.equal(parts[0], parts[1]), name
        rel = ((parts[0].double().sum(0) - ref.double()).norm()
               / ref.double().norm())
        assert rel <= 1e-5, (name, float(rel))

    coefs, saveds, bns = [], [], []
    for i, x in enumerate(xs):
        bn, twin = _bn_module(C, i), _bn_module(C, i)
        sums = T.stats_plain(x)[0]
        summed([T._stats(x) for _ in range(2)], sums, "statistics")
        p1, p2 = sums[:C].view(1, C), sums[C:].view(1, C)
        a, b, saved = T._finish(T.FIN_TRAIN, bn, p1, p2, n, None)
        ref = T.finish_plain(sums[:C], sums[C:], n, twin, twin.weight,
                             twin.bias, True)
        for name, o, r in (("a", a, ref[0]), ("b", b, ref[1]),
                           ("saved", saved, ref[2]),
                           ("running_mean", bn.running_mean,
                            twin.running_mean),
                           ("running_var", bn.running_var, twin.running_var),
                           ("batches", bn.num_batches_tracked,
                            twin.num_batches_tracked)):
            assert torch.equal(o, r), name
        bn.eval()
        ev = T._finish(T.FIN_EVAL, bn, None, None, n, None)
        ref_ev = T.finish_plain(None, None, n, bn, bn.weight, bn.bias, False)
        assert torch.equal(ev[0], ref_ev[0]) and torch.equal(ev[1], ref_ev[1])
        coefs.append((a, b))
        saveds.append(saved)
        bns.append(bn)
    out = T._apply(xs, coefs, ident, True)
    assert torch.equal(out, T.apply_plain(xs, coefs, ident, True)), "apply"
    csums = T.colsum_plain(g, out, xs)[0]
    summed([T._colsum(g, out, xs) for _ in range(2)], csums, "column sums")
    css = []
    for i, (bn, saved) in enumerate(zip(bns, saveds)):
        col = torch.stack([csums[i * C:(i + 1) * C], csums[branches * C:]])
        got = T._finish_bwd(col[:1], col[1:], None, None, saved, bn.weight,
                            n, None, True)
        ref = T.finish_bwd_plain(T._bf(col[0]), T._bf(col[1]), saved,
                                 bn.weight, n, True)
        for name, o, r in zip(("dgamma", "dbeta", "cs"), got, ref):
            assert torch.equal(o, r), name
        css.append(ref[2])
    a_s = [c[0] for c in coefs]
    dxs, did = T._dx(g, out, xs, a_s, css, identity)
    ref_dxs, ref_did = T.dx_plain(g, out, xs, a_s, css, identity)
    for d, r in zip(dxs, ref_dxs):
        assert torch.equal(d, r), "dx"
    if identity:
        assert torch.equal(did, ref_did), "identity gradient"
    torch.cuda.synchronize()
    assert read(counts, *BN_COUNTERS) == (
        2 * branches, 2 * branches, 1, 2, branches, 1)
    with pytest.raises(ValueError):          # not channels-last NCHW
        T.batch_norm(bns[0], xs[0].view(B, H, W, C).permute(0, 3, 1, 2)
                     .contiguous())


def _set_dropout(model, p):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = p
    return model


@pytest.mark.cuda
def test_cuda_graphed_resnet_fusion_step_launches_the_batchnorm_kernels(
        monkeypatch):
    """NewMultiModalMultiTask on the full ResNet50 (stage sizes 3, 4, 6, 3),
    the unit's gate open, batch 8 of 64x64 images, through train_epoch (an
    eager warm-up, then graph replays): each replayed step counts 21
    statistics, 53 finishing and 33 apply launches forward and 33 column
    sums, 53 finishing and 49 dx launches backward (the stem, 16 bn1, 16
    bn2 and 16 tails); with the gate closed 53, 53, 49 and 49, 53, 49; an
    eval batch 53 finishing and 49 apply launches. Two trainers from the
    same weights run the graphed epoch bit-identically."""
    import copy

    from artgraph_tpu_torch.cli._common import multi_task_loss
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.models import heads, init_random_
    from artgraph_tpu_torch.train import Trainer, adam

    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    nc = {"style": 32, "genre": 18}
    src = _set_dropout(init_random_(heads.NewMultiModalMultiTask(128, nc),
                                    torch.Generator().manual_seed(3)), 0.0)
    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
                rng.normal(size=(8, 128)).astype(np.float32),
                rng.normal(size=(8, 128)).astype(np.float32),
                np.stack([rng.integers(0, 32, 8), rng.integers(0, 18, 8)], 1)
                .astype(np.int32), np.ones(8, np.float32)) for _ in range(3)]

    def trainer():
        return Trainer(copy.deepcopy(src), adam(3e-4),
                       multi_task_loss(None, None, 0.5, 0.5, "cuda"),
                       transform_type="resnet", device="cuda",
                       forward_inputs=image_and_embeddings)

    runs = {}
    for gate, per_step in ((True, (21, 53, 33, 33, 53, 49)),
                           (False, (53, 53, 49, 49, 53, 49))):
        if gate:
            monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
        else:
            monkeypatch.delenv("ARTGRAPH_CONVBN", raising=False)
        t = trainer()
        before = launches.snapshot()
        metrics = t.train_epoch(batches)
        counts = launches.since(before)
        torch.cuda.synchronize()
        assert len(t.graphs) == 1
        assert tuple(counts.get(n, 0) for n in BN_COUNTERS) == tuple(
            3 * k for k in per_step), gate
        runs[gate] = (metrics, t)
    before = launches.snapshot()
    runs[True][1].eval_epoch(batches[:1])
    counts = launches.since(before)
    assert tuple(counts.get(n, 0) for n in BN_COUNTERS) == (0, 53, 49, 0,
                                                            0, 0)
    monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    again = trainer()
    assert again.train_epoch(batches) == runs[True][0]
    torch.cuda.synchronize()
    for (name, p), q in zip(again.model.state_dict().items(),
                            runs[True][1].model.state_dict().values()):
        assert torch.equal(p, q), name
    assert launches.COUNTS["batchnorm_apply"] > 0


class _TwoRanks(torch.autograd.Function):
    """psum over two ranks that hold the same tensor: 2x each way."""

    @staticmethod
    def forward(ctx, x):
        return 2.0 * x

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


@pytest.mark.cuda
def test_cuda_data_parallel_batchnorm_sums_before_finishing(monkeypatch):
    """A downsampling Bottleneck (layer3's first at batch 8, the unit's gate
    open) under bn_psum_axis with psum standing for two ranks holding the
    same batch: on the kernels the raw sums and n of each BatchNorm, the
    unit's included, are summed in one [2C + 1] buffer before its
    finishing (merge-only launch, the sum, then the finishing), and (c1,
    c2) after the backward's; output, input gradient, parameter gradients
    and running statistics against the same block on the plain path."""
    import copy

    from artgraph_tpu_torch.models import resnet
    from artgraph_tpu_torch.models.resnet import Bottleneck, bn_psum_axis
    from artgraph_tpu_torch.ops import batchnorm

    _need_cuda()
    monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    seen = []

    def psum(x, axis_name):
        seen.append((torch.is_grad_enabled(), x.shape[0]))
        return _TwoRanks.apply(x)

    monkeypatch.setattr(resnet, "psum", psum)
    torch.manual_seed(5)
    block = Bottleneck(512, 256, stride=2, downsample=True).cuda()
    for i, m in enumerate(block.modules()):
        if isinstance(m, resnet.MixedBatchNorm):
            m.load_state_dict(_bn_module(m.weight.shape[0], i).state_dict())
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(8, 28, 28, 512)).astype(
        np.float32)).to("cuda", torch.bfloat16).permute(0, 3, 1, 2)
    g = torch.from_numpy(rng.normal(size=(8, 14, 14, 1024)).astype(
        np.float32)).to("cuda", torch.bfloat16).permute(0, 3, 1, 2)
    results = {}
    for kernels in (True, False):
        b = copy.deepcopy(block)
        seen.clear()
        with monkeypatch.context() as m:
            if not kernels:
                m.setattr(batchnorm, "takes", lambda t: False)
            xi = x.clone().requires_grad_()
            with bn_psum_axis("data"):
                y = b(xi)
            (y.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        results[kernels] = (y, xi.grad, b, list(seen))
    (y, dx, b, fused), (y_p, dx_p, b_p, plain) = results[True], results[False]
    widths = sorted(2 * c + 1 for c in (256, 256, 1024, 1024))
    assert sorted(w for _, w in plain) == widths
    assert sorted(fused[:4]) == [(False, w) for w in widths]
    assert sorted(fused[4:]) == [(False, w) for w in widths]
    torch.testing.assert_close(y.float(), y_p.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(dx.float(), dx_p.float(), rtol=3e-2,
                               atol=3e-2)
    for (name, p), q in zip(b_p.named_parameters(), b.parameters()):
        rel = (q.grad.double() - p.grad.double()).norm() / p.grad.double() \
            .norm()
        assert rel <= GRAD_REL_L2, (name, float(rel))
    for (name, u), v in zip(b_p.named_buffers(), b.buffers()):
        if u.dtype == torch.long:
            assert torch.equal(u, v), name
        else:
            rel = (u.double() - v.double()).norm() / u.double().norm()
            assert rel <= 1e-4, (name, float(rel))


@pytest.mark.cuda
def test_cuda_resnet_eval_forward_takes_the_batchnorm_kernels(monkeypatch):
    """ResNet50 (stage sizes 3, 4, 6, 3) in eval mode under inference_mode,
    as predict runs it: 53 eval finishing and 49 apply launches (the stem,
    16 bn1, 16 bn2, 16 tails) and no other BatchNorm kernel; the pooled
    feature bit-identical to the plain path's (no sum differs in eval)."""
    from artgraph_tpu_torch.models import ResNet50
    from artgraph_tpu_torch.ops import batchnorm

    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.manual_seed(7)
    trunk = ResNet50().cuda().eval()
    for i, m in enumerate(trunk.modules()):
        if isinstance(m, torch.nn.Module) and hasattr(m, "running_var"):
            m.load_state_dict(_bn_module(m.weight.shape[0], i).state_dict())
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(4, 64, 64, 3)).astype(np.float32)).cuda()
    before = launches.snapshot()
    with torch.inference_mode():
        y = trunk(x)
    counts = launches.since(before)
    with monkeypatch.context() as m, torch.inference_mode():
        m.setattr(batchnorm, "takes", lambda t: False)
        y_plain = trunk(x)
    torch.cuda.synchronize()
    assert counts == {"batchnorm_finish": 53, "batchnorm_apply": 49}
    assert torch.equal(y, y_plain)


@pytest.mark.cuda
def test_cuda_batchnorm_kernels_take_a_saved_checkpoint(tmp_path,
                                                        monkeypatch):
    """A LabelProjector (ResNet50) saved by save_reference_checkpoint and
    loaded by load_reference_checkpoint, as generate_projections loads it:
    every tensor of the file is f32, num_batches_tracked too. Eval under
    inference_mode launches the eval finishing and apply kernels, equal to
    the plain path bit for bit; a train step launches the train kernels,
    and num_batches_tracked (f32) counts as on the plain path. A module
    cast to bf16 raises on an input the kernels take, before any launch."""
    from artgraph_tpu_torch.checkpointing.torch_interop import (
        load_reference_checkpoint, save_reference_checkpoint)
    from artgraph_tpu_torch.models import heads, init_random_
    from artgraph_tpu_torch.ops import batchnorm

    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    path = str(tmp_path / "projector.pt")
    save_reference_checkpoint(init_random_(heads.LabelProjector(128),
                                           torch.Generator().manual_seed(9)),
                              path)
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(4, 64, 64, 3)).astype(np.float32)).cuda()
    plain = lambda m: m.setattr(batchnorm, "takes", lambda t: False)
    outs = {}
    for kernels in (True, False):
        model = load_reference_checkpoint("LabelProjector", path, "cuda")
        nbt = [m.num_batches_tracked for m in model.modules()
               if hasattr(m, "num_batches_tracked")]
        assert nbt and all(t.dtype == torch.float32 for t in nbt)
        with monkeypatch.context() as m:
            if not kernels:
                plain(m)
            before = launches.snapshot()
            with torch.inference_mode():
                y_eval = model(x)
            eval_counts = launches.since(before)
            model.train()
            before = launches.snapshot()
            model(x).float().square().sum().backward()
            train_counts = launches.since(before)
        torch.cuda.synchronize()
        outs[kernels] = (y_eval, [t.item() for t in nbt], eval_counts,
                         train_counts)
    (y, nbt_k, eval_k, train_k), (y_p, nbt_p, eval_p, train_p) = \
        outs[True], outs[False]
    assert torch.equal(y, y_p)
    assert nbt_k == nbt_p == [1.0] * len(nbt_k)
    assert eval_k == {"batchnorm_finish": 53, "batchnorm_apply": 49}
    assert train_k["batchnorm_finish"] == 53 and train_k["batchnorm_dx"] == 49
    assert not any(k.startswith("batchnorm_") for k in {**eval_p, **train_p})
    cast = _bn_module(64, 0).bfloat16()
    before = launches.snapshot()
    with pytest.raises(ValueError, match="weight must be"):
        cast(torch.ones((2, 64, 4, 4), device="cuda", dtype=torch.bfloat16)
             .contiguous(memory_format=torch.channels_last))
    assert launches.since(before) == {}
