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
"""
import numpy as np
import pytest
import torch

from artgraph_tpu_torch.ops import (attention, block_attention_bwd_plain,
                                    block_attention_plain, block_mlp_bwd_plain,
                                    block_mlp_plain, conv_bn, csr_segment,
                                    fused_block_attention, fused_block_mlp,
                                    mlp, normalize_images,
                                    normalize_images_plain, preprocess)

GRAD_REL_L2 = 2e-2
GRAD_MAX_REL = 0.1
GRAD_NAMES = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


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
    ours = attention.layernorm_bwd_cuda(x, gamma, dy, dres, 1e-6)
    again = attention.layernorm_bwd_cuda(x, gamma, dy, dres, 1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(ours, again))
    ref = attention.ln_bwd_plain(x, gamma, dy, dres, 1e-6)
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
    ours, again = attention.colsum_cuda(t), attention.colsum_cuda(t)
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
        attention.layernorm_bwd_cuda(z(4, 1032), z(1032, dt=torch.float32),
                                     z(4, 1032, dt=torch.float32),
                                     z(4, 1032), 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.layernorm_bwd_cuda(z(4, 68), z(68, dt=torch.float32),
                                     z(4, 68, dt=torch.float32), z(4, 68),
                                     1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.colsum_cuda(z(4, 68))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_backward_reaches_every_block_parameter(monkeypatch):
    """backward() through both block ops on cuda: each parameter gets a
    finite f32 gradient from the backward kernels, x a bf16 one."""
    _need_cuda()
    for mod in (attention, mlp):
        monkeypatch.setattr(mod, "LAUNCHES_BWD", 0)
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
    assert (attention.LAUNCHES_BWD, mlp.LAUNCHES_BWD) == (1, 1)
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
    for mod in (attention, mlp, preprocess):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    C = 128
    x, gamma, beta, lin = block_inputs(2, 9, C, ((C, 3 * C), (C, C)), seed=0)
    tx, params = torch_args(x, gamma, beta, lin, torch.bfloat16)
    tx, params = tx.cuda(), [p.cuda() for p in params]
    fused_block_attention(tx, *params, 2)
    normalize_images(torch.zeros((1, 8, 8, 3), dtype=torch.uint8,
                                 device="cuda"), "vit")
    torch.cuda.synchronize()
    assert (attention.LAUNCHES, mlp.LAUNCHES, preprocess.LAUNCHES) == (1, 0, 1)

    with pytest.raises(TypeError):          # x must be bf16
        fused_block_attention(tx.float(), *params, 2)
    with pytest.raises(TypeError):          # params must be f32
        fused_block_attention(tx, *[p.half() for p in params], 2)
    with pytest.raises(ValueError):         # x must be contiguous
        fused_block_attention(tx.transpose(0, 1), *params, 2)
    with pytest.raises(ValueError):         # head dim 128/4 = 32 not built
        fused_block_attention(tx, *params, 4)
    with pytest.raises(TypeError):          # images must be uint8
        normalize_images(torch.zeros((1, 8, 8, 3), device="cuda"), "vit")
    assert (attention.LAUNCHES, preprocess.LAUNCHES) == (1, 1)

    # the block GEMM refuses, before any launch, what its TMA loads and
    # 16-byte stores cannot take: rows not a multiple of 8 elements
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16,
                                    device="cuda")
    bias = torch.zeros(64, device="cuda")
    for a, b, layout, epi in (
            (bf(16, 36), bf(64, 36), attention.LAYOUT_NT, attention.EPI_BIAS),
            (bf(16, 32), bf(60, 32), attention.LAYOUT_NT, attention.EPI_BIAS),
            (bf(16, 36), bf(36, 64), attention.LAYOUT_NN, attention.EPI_NONE),
            (bf(16, 32), bf(32, 60), attention.LAYOUT_NN, attention.EPI_F32),
            (bf(40, 12), bf(40, 64), attention.LAYOUT_TN, attention.EPI_F32),
            (bf(40, 16), bf(40, 20), attention.LAYOUT_TN, attention.EPI_F32)):
        with pytest.raises(ValueError, match="not a shape the kernel takes"):
            attention.gemm_cuda(a, b, layout, epi, bias=bias[:b.shape[0]])
    torch.cuda.synchronize()


# every (layout, epilogue) pair csrc/block_gemm.cu builds
GEMM_PAIRS = ([(attention.LAYOUT_NT, e) for e in (
    attention.EPI_BIAS, attention.EPI_BIAS_GELU, attention.EPI_BIAS_RESIDUAL,
    attention.EPI_BIAS_GELU_AUX)]
    + [(attention.LAYOUT_NN, e) for e in (
        attention.EPI_NONE, attention.EPI_F32, attention.EPI_DGELU)]
    + [(attention.LAYOUT_TN, attention.EPI_F32)])


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
    A = attention
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
    for name in ("LAUNCHES_SUM", "LAUNCHES_WEIGHTED", "LAUNCHES_SOFTMAX",
                 "LAUNCHES_SCALAR"):
        monkeypatch.setattr(csr_segment, name, 0)
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
    assert (T.LAUNCHES_SUM, T.LAUNCHES_WEIGHTED, T.LAUNCHES_SOFTMAX,
            T.LAUNCHES_SCALAR) == (2, 2, 2, 2)
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
    monkeypatch.setattr(csr_segment, "LAUNCHES_SCALAR", 0)
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
    assert csr_segment.LAUNCHES_SCALAR == 2


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
    monkeypatch.setattr(conv_bn, "LAUNCHES", 0)
    monkeypatch.setattr(conv_bn, "LAUNCHES_BWD", 0)
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
    assert (conv_bn.LAUNCHES, conv_bn.LAUNCHES_BWD) == (1, 1)
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
    for name in ("LAUNCHES_ATTENTION", "LAUNCHES_ATTENTION_BWD",
                 "LAUNCHES_QKV", "LAUNCHES_QKV_BWD"):
        monkeypatch.setattr(attention, name, 0)
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
    assert (attention.LAUNCHES_ATTENTION, attention.LAUNCHES_ATTENTION_BWD,
            attention.LAUNCHES_QKV, attention.LAUNCHES_QKV_BWD) == (1, 1, 1, 1)


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
    for mod in (attention, mlp):
        for name in ("LAUNCHES", "LAUNCHES_BWD"):
            monkeypatch.setattr(mod, name, 0)
    vit = init_random_(ViT(img_size=32, patch_size=16, embed_dim=128,
                           depth=2, num_heads=2, fuse_qkv=False), gen).cuda()
    vit(torch.randn(2, 32, 32, 3, generator=gen).cuda()).square().sum() \
        .backward()
    torch.cuda.synchronize()
    for name, p in vit.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    assert (attention.LAUNCHES, attention.LAUNCHES_BWD, mlp.LAUNCHES,
            mlp.LAUNCHES_BWD) == (0, 0, 0, 0)


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
    for mod in (attention, mlp, preprocess):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    for mod in (attention, mlp):
        monkeypatch.setattr(mod, "LAUNCHES_BWD", 0)
    m = trainer.train_epoch([batch])
    torch.cuda.synchronize()
    assert (preprocess.LAUNCHES, attention.LAUNCHES, mlp.LAUNCHES,
            attention.LAUNCHES_BWD, mlp.LAUNCHES_BWD) == (1, 2, 2, 2, 2)
    assert np.isfinite(m["loss"]) and set(m) >= {"style_correct",
                                                 "genre_correct"}
    for n, p in model.named_parameters():
        if n.startswith("vit.head."):         # timm's head, never called
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
        for mod in (conv_bn, preprocess):
            monkeypatch.setattr(mod, "LAUNCHES", 0)
        monkeypatch.setattr(conv_bn, "LAUNCHES_BWD", 0)
        loss, _ = trainer.train_step(trainer.to_device(batch))
        torch.cuda.synchronize()
        units = 2 * len(stages) if gate else 0
        assert (conv_bn.LAUNCHES, conv_bn.LAUNCHES_BWD, preprocess.LAUNCHES) \
            == (units, units, 1), gate
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
