"""The port's CSR segment ops (artgraph_tpu_torch.ops.csr_segment) against the
JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do; the port runs the kernels' plain twins (CPU tensors). The same
numpy-seeded inputs go through both, at E = 5000 edges on two graphs:
'uniform' (400 sources, 300 destinations) and 'hub' (70% of the edges into
destination 7 and half of them out of source 3, with empty segments on both
sides). Values and gradients (a seeded cotangent through jax.vjp and
torch.autograd.grad) agree at rtol = atol = 1e-4, atol 1e-3 on the hub graph
(the bound of tests/test_csr_segment.py:49): only the summation order
differs. The metadata is compared exactly.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu.ops import csr_segment as J
from artgraph_tpu_torch.ops import csr_segment as T, launches

E = 5000
KINDS = ("uniform", "hub")
ROW_OPS = ("segment_sum", "segment_mean", "weighted_segment_sum",
           "attention_aggregate", "gather_src", "gather_dst")
SCALAR_OPS = ("scalar_segment_sum", "gather_src_1d", "gather_dst_1d")


def edge_index(kind: str):
    """([2, E] int32, num_src, num_dst)."""
    rng = np.random.default_rng(0 if kind == "uniform" else 2)
    if kind == "uniform":
        n_src, n_dst = 400, 300
        src = rng.integers(0, n_src, E)
        dst = rng.integers(0, n_dst, E)
    else:
        n_src, n_dst = 100, 90
        src = np.where(rng.random(E) < 0.5, 3, rng.integers(60, n_src, E))
        dst = np.where(rng.random(E) < 0.7, 7, rng.integers(50, n_dst, E))
    return np.stack([src, dst]).astype(np.int32), n_src, n_dst


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for kind in KINDS:
        ei, n_src, n_dst = edge_index(kind)
        out[kind] = (J.build_edge_csr(ei, n_src, n_dst)[1],
                     T.build_edge_csr(ei, n_src, n_dst)[1], n_src, n_dst)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_metadata_matches_jax(kind):
    ei, n_src, n_dst = edge_index(kind)
    se_j, ej = J.build_edge_csr(ei, n_src, n_dst)
    se_t, et = T.build_edge_csr(ei, n_src, n_dst)
    np.testing.assert_array_equal(se_t, se_j)
    for side in ("dst", "src"):
        cj, ct = getattr(ej, side), getattr(et, side)
        assert (ct.num_segments, ct.num_edges) == (cj.num_segments,
                                                   cj.num_edges)
        np.testing.assert_array_equal(ct.counts.numpy(), np.asarray(cj.counts))
        np.testing.assert_array_equal(ct.dst_sorted.numpy(),
                                      np.asarray(cj.dst_sorted)[:E])
        # the port's per-segment pointer at the Pallas block boundaries is
        # the Pallas block pointer
        bounds = np.minimum(np.arange(cj.num_blocks + 1) * J.S_BLK,
                            cj.num_segments)
        np.testing.assert_array_equal(ct.row_ptr.numpy()[bounds],
                                      np.asarray(cj.block_ptr))
        np.testing.assert_array_equal(np.diff(ct.row_ptr.numpy()),
                                      ct.counts.numpy())
    np.testing.assert_array_equal(et.src_perm.numpy(), np.asarray(ej.src_perm))
    np.testing.assert_array_equal(et.src_ids.numpy(), np.asarray(ej.src_ids))


def op_pair(op: str, ej, et):
    """(jax fn, port fn, input kinds) of one public op on one graph."""
    table = {
        "segment_sum": (lambda d: J.csr_segment_sum(d, ej.dst),
                        lambda d: T.csr_segment_sum(d, et.dst), ("rows",)),
        "segment_mean": (lambda d: J.csr_segment_mean(d, ej.dst),
                         lambda d: T.csr_segment_mean(d, et.dst), ("rows",)),
        "weighted_segment_sum": (
            lambda d, w: J.csr_weighted_segment_sum(d, w, ej.dst),
            lambda d, w: T.csr_weighted_segment_sum(d, w, et.dst),
            ("rows", "edge")),
        "attention_aggregate": (
            lambda d, l: J.csr_attention_aggregate(d, l, ej.dst),
            lambda d, l: T.csr_attention_aggregate(d, l, et.dst),
            ("rows", "edge")),
        "gather_src": (lambda x: J.csr_gather(x, ej, "src"),
                       lambda x: T.csr_gather(x, et, "src"), ("src_rows",)),
        "gather_dst": (lambda x: J.csr_gather(x, ej, "dst"),
                       lambda x: T.csr_gather(x, et, "dst"), ("dst_rows",)),
        "scalar_segment_sum": (lambda w: J.csr_scalar_segment_sum(w, ej.dst),
                               lambda w: T.csr_scalar_segment_sum(w, et.dst),
                               ("edge",)),
        "gather_src_1d": (lambda x: J.csr_gather(x, ej, "src"),
                          lambda x: T.csr_gather(x, et, "src"), ("src",)),
        "gather_dst_1d": (lambda x: J.csr_gather(x, ej, "dst"),
                          lambda x: T.csr_gather(x, et, "dst"), ("dst",)),
    }
    return table[op]


def check_against_jax(jfn, tfn, inputs, atol: float, seed: int):
    """Values and the gradients of a seeded cotangent, JAX vs the port."""
    outs_j, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in inputs])
    t_in = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs_t = tfn(*t_in)
    single = not isinstance(outs_j, tuple)
    outs_j = (outs_j,) if single else outs_j
    outs_t = (outs_t,) if single else outs_t
    rng = np.random.default_rng(seed)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs_j]
    for oj, ot in zip(outs_j, outs_t):
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                                   rtol=1e-4, atol=atol)
    grads_j = vjp(cots[0] if single else tuple(cots))
    grads_t = torch.autograd.grad(outs_t, t_in,
                                  [torch.from_numpy(c) for c in cots])
    for gj, gt in zip(grads_j, grads_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=atol)


def make_inputs(kinds, F: int, n_src: int, n_dst: int, seed: int,
                hot_logit: bool = False):
    rng = np.random.default_rng(seed)
    shapes = {"rows": (E, F), "edge": (E,), "src_rows": (n_src, F),
              "dst_rows": (n_dst, F), "src": (n_src,), "dst": (n_dst,)}
    inputs = [rng.normal(size=shapes[k]).astype(np.float32) for k in kinds]
    if hot_logit:
        inputs[1][0] += 200.0   # one scorching edge
    return inputs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("F", [128, 18])
@pytest.mark.parametrize("op", ROW_OPS)
def test_row_op_matches_jax(graphs, op, F, kind):
    ej, et, n_src, n_dst = graphs[kind]
    jfn, tfn, kinds = op_pair(op, ej, et)
    inputs = make_inputs(kinds, F, n_src, n_dst, seed=F + len(op))
    check_against_jax(jfn, tfn, inputs, 1e-4 if kind == "uniform" else 1e-3,
                      seed=F)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", SCALAR_OPS)
def test_scalar_op_matches_jax(graphs, op, kind):
    ej, et, n_src, n_dst = graphs[kind]
    jfn, tfn, kinds = op_pair(op, ej, et)
    inputs = make_inputs(kinds, 1, n_src, n_dst, seed=len(op))
    check_against_jax(jfn, tfn, inputs, 1e-4 if kind == "uniform" else 1e-3,
                      seed=3)


@pytest.mark.parametrize("F", [128, 18])
def test_attention_extreme_logit_spread_matches_jax(graphs, F):
    """One logit +200: the per-segment shift keeps the cold segments exact
    (a global shift would zero them), in values and gradients."""
    ej, et, n_src, n_dst = graphs["uniform"]
    jfn, tfn, kinds = op_pair("attention_aggregate", ej, et)
    inputs = make_inputs(kinds, F, n_src, n_dst, seed=6, hot_logit=True)
    check_against_jax(jfn, tfn, inputs, 1e-4, seed=7)
    d = torch.from_numpy(inputs[0]).requires_grad_()
    tfn(d, torch.from_numpy(inputs[1])).sum().backward()
    assert float(d.grad.abs().sum()) > 1.0


def test_cpu_tensors_take_the_plain_twins(graphs, monkeypatch):
    """On CPU tensors no kernel counter moves, and each op's forward equals
    its plain twin exactly."""
    monkeypatch.setattr(launches, "COUNTS", collections.Counter())
    _, et, n_src, _ = graphs["hub"]
    d, w = make_inputs(("rows", "edge"), 18, n_src, 0, seed=9)
    d, w = torch.from_numpy(d), torch.from_numpy(w)
    torch.testing.assert_close(T.csr_segment_sum(d, et.dst),
                               T.segment_sum_plain(d, et.dst), rtol=0, atol=0)
    num, m, den = T.softmax_aggregate_plain(d, w, et.dst)
    torch.testing.assert_close(T.csr_attention_aggregate(d, w, et.dst),
                               num / den.clamp_min(1e-16)[:, None],
                               rtol=0, atol=0)
    empty = et.dst.counts == 0
    assert bool(empty.any()) and bool((m[empty] == -torch.inf).all())
    assert bool((num[empty] == 0).all()) and bool((den[empty] == 0).all())
    T.csr_scalar_segment_sum(w, et.dst)
    T.csr_weighted_segment_sum(d, w, et.dst)
    assert tuple(launches.COUNTS[k] for k in (
        "csr_segment_sum", "csr_weighted_segment_sum",
        "csr_attention_aggregate", "csr_scalar_segment_sum")) == (0, 0, 0, 0)


def emulate_plan(csr, data: np.ndarray, logits: np.ndarray):
    """The two passes of csr_segment.cu's row kernels over the chunk plan,
    in f64 numpy: per chunk (sum of rows, softmax num, m, den), then the
    merge of the hub segments' partials. Returns (sum, num, m, den)."""
    plan, C, M = csr.plan.numpy(), csr.num_chunks, csr.num_merge
    edge, seg, slot, merge_seg, merge_ptr = np.split(
        plan, np.cumsum([C + 1, C, C, M]))
    S, F = csr.num_segments, data.shape[1]
    rows = lambda n: (np.zeros((n, F)), np.zeros((n, F)), np.full(n, -np.inf),
                      np.zeros(n))
    out, part = rows(S), rows(csr.num_slots)
    for c in range(C):
        d, lg = data[edge[c]:edge[c + 1]], logits[edge[c]:edge[c + 1]]
        m = lg.max() if lg.size else -np.inf
        w = np.exp(lg - (m if np.isfinite(m) else 0.0))
        dst, r = (out, seg[c]) if slot[c] < 0 else (part, slot[c])
        dst[0][r], dst[1][r], dst[2][r], dst[3][r] = (d.sum(0), w @ d, m,
                                                       w.sum())
    for i, s in enumerate(merge_seg):
        sl = slice(merge_ptr[i], merge_ptr[i + 1])
        mx = part[2][sl].max()
        scale = np.where(np.isfinite(part[2][sl]),
                         np.exp(part[2][sl] - mx), 0.0)
        out[0][s] = part[0][sl].sum(0)
        out[1][s], out[2][s], out[3][s] = (scale @ part[1][sl], mx,
                                           scale @ part[3][sl])
    return out


def strided_sum(x: np.ndarray, lanes: int) -> float:
    """csr_segment.cu's strided_sum in f64: lane l of `lanes` adds
    x[l + lanes k] for k = 0, 1, ... in order (the rounds of 8 loads pad
    with zeros), then the shuffle tree: lane l += lane l + off for off =
    lanes / 2 .. 1. Lane 0's sum."""
    acc = np.zeros(lanes)
    padded = np.zeros(-(-x.size // (8 * lanes)) * 8 * lanes)
    padded[:x.size] = x
    for row in padded.reshape(-1, lanes):
        acc = acc + row
    off = lanes // 2
    while off:
        acc[:lanes - off] = acc[:lanes - off] + acc[off:]
        off //= 2
    return acc[0]


def emulate_scalar_plan(csr, w: np.ndarray) -> np.ndarray:
    """The two passes of csr_segment.cu's scalar sum over the chunk plan,
    in f64 numpy: a group of csr.scalar_lanes lanes per chunk, then one
    warp per hub over its partials, each in strided_sum's order."""
    plan, C, M = csr.plan.numpy(), csr.num_chunks, csr.num_merge
    edge, seg, slot, merge_seg, merge_ptr = np.split(
        plan, np.cumsum([C + 1, C, C, M]))
    out, part = np.zeros(csr.num_segments), np.zeros(csr.num_slots)
    for c in range(C):
        dst, r = (out, seg[c]) if slot[c] < 0 else (part, slot[c])
        dst[r] = strided_sum(w[edge[c]:edge[c + 1]], csr.scalar_lanes)
    for i, s in enumerate(merge_seg):
        out[s] = strided_sum(part[merge_ptr[i]:merge_ptr[i + 1]], 32)
    return out


@pytest.mark.parametrize("counts", [[0, 3, 256, 257, 0, 1000, 5],
                                    [31000, 0, 7], [0, 0], [],
                                    [55556, 2, 0, 300], [3, 10, 0, 7, 40],
                                    [90, 70, 0, 100]])
def test_chunk_plan_reduces_like_the_plain_twins(counts):
    """The plan the CUDA kernels walk: chunks of at most CHUNK edges
    that tile each segment's edges in order (one empty chunk per empty
    segment), partial slots exactly for the segments of several chunks. Its
    two passes, emulated, give the plain twins' sums and softmax parts; the
    scalar sum's order (lane-strided, a shuffle tree, then the hubs' slots
    the same way) gives scalar_segment_sum_plain's sums in f64 and the JAX
    package's csr_scalar_segment_sum (Pallas, interpret mode) within
    check_against_jax's bounds."""
    counts = np.asarray(counts, np.int64)
    ids = np.repeat(np.arange(counts.size), counts)
    csr = T._csr_from_sorted(ids, counts.size, "cpu")
    C = csr.num_chunks
    edge = csr.plan.numpy()[:C + 1]
    n_chunks = np.maximum(1, -(-counts // T.CHUNK))
    assert C == n_chunks.sum() and edge[0] == 0 and edge[-1] == ids.size
    assert np.all(np.diff(edge) >= 0) and np.all(np.diff(edge) <= T.CHUNK)
    assert csr.num_merge == int((n_chunks > 1).sum())
    assert csr.num_slots == int(n_chunks[n_chunks > 1].sum())
    rng = np.random.default_rng(counts.size)
    data = rng.normal(size=(ids.size, 5))
    logits = rng.normal(size=ids.size)
    logits[:1] += 200.0
    s, num, m, den = emulate_plan(csr, data, logits)
    td, tl = torch.from_numpy(data), torch.from_numpy(logits)
    np.testing.assert_allclose(s, T.segment_sum_plain(td, csr).numpy(),
                               rtol=1e-12, atol=1e-12)
    plain = T.softmax_aggregate_plain(td, tl, csr)
    for got, want in zip((num, m, den), plain):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)

    w = rng.normal(size=ids.size).astype(np.float32)
    scalar = emulate_scalar_plan(csr, w.astype(np.float64))
    np.testing.assert_allclose(
        scalar, T.scalar_segment_sum_plain(torch.from_numpy(w).double(),
                                           csr).numpy(),
        rtol=1e-12, atol=1e-12)
    if ids.size:
        jcsr = J._csr_from_sorted(ids, counts.size)
        atol = 1e-3 if counts.max() > T.CHUNK else 1e-4
        np.testing.assert_allclose(
            scalar, np.asarray(J.csr_scalar_segment_sum(jnp.asarray(w),
                                                        jcsr)),
            rtol=1e-4, atol=atol)


def test_metadata_rejects_unsorted_or_out_of_range_ids():
    with pytest.raises(ValueError):
        T._csr_from_sorted(np.array([0, 2, 1]), 3, "cpu")
    with pytest.raises(ValueError):
        T._csr_from_sorted(np.array([0, 1, 3]), 3, "cpu")
    with pytest.raises(ValueError):
        T.csr_gather(torch.zeros(3), None, "both")
