"""The port's `fused_attention` and `fused_qkv_attention` against the JAX
package, and the modules that reach them: the standalone `Attention` and
`ViT(fuse_qkv=False)`.

On the CPU each op runs its plain PyTorch twins, which share the CUDA
kernels' rounding points; here they are held against the Pallas kernels
(interpret mode, as tests/test_attention.py runs them) on the same numpy
inputs. Tolerances: f32 at rtol = atol = 1e-4 (accumulation order only);
bf16 elementwise at |a - b| <= 3e-2 (|b| + mean|b|), which a one-ulp flip
passes and a wrong term does not, and for `fused_attention` also at
max|a - b| / mean|b| <= 3e-2. (That second bound does not fit the qkv op: at
(2, 197, 256, 4) the twin differs from the Pallas kernel in 0.25% of the
outputs, by one ulp, 0.0301 of the mean, while bf16 itself lies 0.044 from
f32 by that measure.) The backwards get the JAX forward's own output, so a
one-ulp flip of the forward does not reach them. Module gradients: relative
L2 <= 2e-2, in f32 (one SGD step's update is the learning rate times the
gradient; SGD, not Adam: the qkv K-bias gradient is zero in exact
arithmetic and Adam would amplify its noise). Weights move through the
port's converters.

The CUDA attention cores run only on the card, so their decomposition is
rehearsed here in PyTorch (`tiled_forward`, `tiled_backward`): 64-row
resident tiles and 32-row streamed stages, rows padded with zeros, keys >= N
masked to -inf in the ragged last stage, the forward's two passes over the
key stages, the backward's three phases. That emulation is held against the
Pallas `fused_attention` and its VJP (interpret mode), and against the block
path's plain twins of the core (`core_plain`, `core_bwd_plain`), at the
tolerances above, for N = 65, 197 and 600.

tests/test_torch_cuda.py holds the CUDA kernels against the twins on the
card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu.models.vit import (Attention as JaxAttention,
                                     ViT as JaxViT, force_pallas_kernels)
from artgraph_tpu.ops import attention as J
from artgraph_tpu_torch.checkpointing import (attention_state_from_flax,
                                              vit_state_from_flax)
from artgraph_tpu_torch.models import ViT
from artgraph_tpu_torch.models.vit import Attention
from artgraph_tpu_torch.ops import (fused_attention,
                                    fused_attention_bwd_plain,
                                    fused_attention_plain,
                                    fused_qkv_attention,
                                    fused_qkv_attention_bwd_plain,
                                    fused_qkv_attention_plain)
from artgraph_tpu_torch.ops.attention import core_bwd_plain, core_plain
from test_torch_vit import TINY, seeded_params

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_REL_L2 = 2e-2


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(ours, ref, dtype: str, what: str = "",
           max_rel: bool = False) -> None:
    a, r = _np(ours), _np(ref)
    assert a.shape == r.shape, (what, a.shape, r.shape)
    if dtype == "float32":
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-4, err_msg=what)
        return
    mean = np.abs(r).mean()
    np.testing.assert_allclose(a, r, rtol=3e-2, atol=3e-2 * mean,
                               err_msg=what)
    if max_rel:
        rel = np.abs(a - r).max() / mean
        assert rel <= 3e-2, (what, float(rel))


def _both(a: np.ndarray, dtype: str):
    """One numpy array as (jax, torch) tensors of dtype."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _normal(rng, shape, scale=1.0) -> np.ndarray:
    return (scale * rng.normal(size=shape)).astype(np.float32)


# --- fused_attention --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((2, 197, 4, 64), None),
                                         ((1, 64, 2, 64), 0.5)])
def test_fused_attention_twins_match_jax(shape, scale, dtype):
    """q, k, v are strided views of one [B, N, 3, H, D] tensor on both
    sides; forward and the three gradients of jax.vjp."""
    B, N, H, D = shape
    rng = np.random.default_rng(N)
    jqkv, tqkv = _both(_normal(rng, (B, N, 3, H, D)), dtype)
    jq, jk, jv = (jqkv[:, :, i] for i in range(3))
    out, vjp = jax.vjp(lambda q, k, v: J.fused_attention(q, k, v, scale),
                       jq, jk, jv)
    jdo, tdo = _both(_normal(rng, shape), dtype)
    grads = vjp(jdo)

    tq, tk, tv = tqkv.unbind(2)
    assert tq.stride(1) == 3 * H * D            # views, not copies
    ours = fused_attention_plain(tq, tk, tv, scale)
    assert ours.dtype == tq.dtype
    _close(ours, out, dtype, "out", max_rel=True)
    _, tout = _both(_np(out), dtype)
    for name, a, r in zip(("dq", "dk", "dv"),
                          fused_attention_bwd_plain(tq, tk, tv, tout, tdo,
                                                    scale), grads):
        assert a.dtype == tq.dtype
        _close(a, r, dtype, name, max_rel=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_autograd_gives_the_twins(dtype):
    """fused_attention on the CPU: the forward twin, and backward() through
    the strided views of qkv gives the backward twin's dq, dk, dv."""
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(_normal(rng, (2, 33, 3, 2, 64))).to(tdt)
    do = torch.from_numpy(_normal(rng, (2, 33, 2, 64))).to(tdt)
    leaf = qkv.clone().requires_grad_()
    out = fused_attention(*leaf.unbind(2))
    out.backward(do)
    ref = fused_attention_plain(*qkv.unbind(2))
    assert torch.equal(out.detach(), ref)
    grads = fused_attention_bwd_plain(*qkv.unbind(2), ref, do)
    assert torch.equal(leaf.grad, torch.stack(grads, 2))


# --- fused_qkv_attention ----------------------------------------------------

def _qkv_case(B, N, C, dtype, seed):
    """x, w [C, 3C] (flax layout), b as numpy f32 and both sides' tensors:
    the port's w is [3C, C], x in dtype, w and b f32."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, (B, N, C))
    w = _normal(rng, (C, 3 * C), 1.0 / np.sqrt(C))
    b = _normal(rng, (3 * C,), 0.1)
    jx, tx = _both(x, dtype)
    return (jx, jnp.asarray(w), jnp.asarray(b),
            tx, torch.from_numpy(w.T.copy()), torch.from_numpy(b), rng)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,C,H", [(2, 197, 256, 4), (2, 64, 128, 2)])
def test_fused_qkv_attention_twins_match_jax(B, N, C, H, dtype):
    jx, jw, jb, tx, tw, tb, rng = _qkv_case(B, N, C, dtype, seed=C)
    out, vjp = jax.vjp(lambda x, w, b: J.fused_qkv_attention(x, w, b, H),
                       jx, jw, jb)
    jdo, tdo = _both(_normal(rng, (B, N, C)), dtype)
    dx, dw, db = vjp(jdo)

    ours = fused_qkv_attention_plain(tx, tw, tb, H)
    assert ours.dtype == tx.dtype and ours.shape == (B, N, C)
    _close(ours, out, dtype, "out")
    _, tout = _both(_np(out), dtype)
    odx, odw, odb = fused_qkv_attention_bwd_plain(tx, tw, tb, tout, tdo, H)
    assert odx.dtype == tx.dtype
    assert odw.dtype == odb.dtype == torch.float32
    _close(odx, dx, dtype, "dx")
    _close(odw.t(), dw, dtype, "dw")
    _close(odb, db, dtype, "db")


def test_fused_qkv_attention_vit_geometry_forward():
    """The ViT-B/16 block geometry (N = 197, C = 768, 12 heads) in bf16."""
    jx, jw, jb, tx, tw, tb, _ = _qkv_case(2, 197, 768, "bfloat16", seed=7)
    ref = J.fused_qkv_attention(jx, jw, jb, 12)
    _close(fused_qkv_attention(tx, tw, tb, 12), ref, "bfloat16", "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_twins_read_the_saved_output(dtype):
    """The Pallas backwards take d_row from the saved output o, not from a
    recomputed one. Given an o with 10% noise, the JAX residual functions
    move, and the port's twins, given the same o, move with them."""
    rng = np.random.default_rng(11)
    B, N, H, D = 2, 64, 2, 64
    C = H * D
    jqkv, tqkv = _both(_normal(rng, (B, N, 3, H, D)), dtype)
    jq, jk, jv = (jqkv[:, :, i] for i in range(3))
    out = _np(J.fused_attention(jq, jk, jv))
    noisy = out * (1 + 0.1 * _normal(rng, out.shape))
    jdo, tdo = _both(_normal(rng, (B, N, H, D)), dtype)
    true = J._fused_attention_bwd(None, (jq, jk, jv, _both(out, dtype)[0]),
                                  jdo)
    jo, to = _both(noisy, dtype)
    ref = J._fused_attention_bwd(None, (jq, jk, jv, jo), jdo)
    assert np.abs(_np(ref[0]) - _np(true[0])).max() > 0.1 * np.abs(
        _np(true[0])).mean()
    for name, a, r in zip(("dq", "dk", "dv"), fused_attention_bwd_plain(
            *tqkv.unbind(2), to, tdo), ref):
        _close(a, r, dtype, name, max_rel=True)

    jx, jw, jb, tx, tw, tb, _ = _qkv_case(B, N, C, dtype, seed=12)
    jdt = DTYPES[dtype][0]
    out = _np(J.fused_qkv_attention(jx, jw, jb, H))
    jo, to = _both(out * (1 + 0.1 * _normal(rng, out.shape)), dtype)
    jdo, tdo = _both(_normal(rng, (B, N, C)), dtype)
    dx, dw, db = J._fused_qkv_bwd(
        H, None, (jx, jw.astype(jdt), jb.astype(jdt).reshape(1, -1), jo),
        jdo)
    odx, odw, odb = fused_qkv_attention_bwd_plain(tx, tw, tb, to, tdo, H)
    _close(odx, dx, dtype, "dx")
    _close(odw.t(), dw, dtype, "dw")
    _close(odb, db, dtype, "db")


# --- the CUDA cores' tiled decomposition ------------------------------------

# csrc/block_attention{,_bwd}.cu: a block keeps a 64-row tile of one operand
# and streams the other in 32-row stages
TILE, STAGE = 64, 32


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero rows up to `rows`: the zero-filled shared-memory rows past N."""
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[-2]))


def _stage(t: torch.Tensor, j: int) -> torch.Tensor:
    return t[..., j * STAGE:(j + 1) * STAGE, :]


def _stages(N: int) -> int:
    return -(-N // STAGE)


def _stage_scores(q, k, j: int, N: int, scale: float) -> torch.Tensor:
    """f32 scores of every (padded) query row against key stage j, the keys
    >= N of the ragged last stage at -inf."""
    s = (q.float() @ _stage(k, j).float().transpose(-1, -2)) * scale
    return s.masked_fill(torch.arange(j * STAGE, (j + 1) * STAGE) >= N,
                         -math.inf)


def _tiled_row_stats(q, k, N: int, scale: float):
    """The block path's pass 1 and the backward's phase 1: each row's max m
    and sum l, key stage by key stage, merged with the rescale."""
    m = torch.full((*q.shape[:-1], 1), -math.inf)
    l = torch.zeros_like(m)
    for j in range(_stages(N)):
        s = _stage_scores(q, k, j, N, scale)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        m = mn
    return m, l


def tiled_forward(q, k, v, scale: float, divide_before: bool):
    """Kernel A on [B, H, N, D] heads in their dtype. The block path: pass 1
    gives (m, l), pass 2 rounds p = dtype(e / l) against them and
    accumulates p . v stage by stage. The strided path: pass 1 gives m
    alone, pass 2 rounds dtype(e), sums l from the same e and divides the
    f32 product by it. Returns o in dtype."""
    dt, N = q.dtype, q.shape[-2]
    rows = -(-N // TILE) * TILE
    q, k, v = (_pad_rows(t, rows) for t in (q, k, v))
    if divide_before:
        m, l = _tiled_row_stats(q, k, N, scale)
    else:
        m = torch.stack([_stage_scores(q, k, j, N, scale).amax(-1)
                         for j in range(_stages(N))]).amax(0)[..., None]
        l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for j in range(_stages(N)):
        e = torch.exp(_stage_scores(q, k, j, N, scale) - m)
        if not divide_before:
            l = l + e.sum(-1, keepdim=True)
        p = (e / l if divide_before else e).to(dt)
        o = o + p.float() @ _stage(v, j).float()
    if not divide_before:
        o = o / l
    return o[..., :N, :].to(dt)


def tiled_backward(q, k, v, do, scale: float, o=None):
    """Kernel B's three phases on [B, H, N, D] heads in their dtype; o is
    the saved output (the strided path), or None for the block path, whose
    d_row is sum_j p_j dp_j. Returns (dq, dk, dv) in dtype."""
    dt, N = q.dtype, q.shape[-2]
    rows = -(-N // TILE) * TILE
    T = _stages(N)
    q, k, v, do = (_pad_rows(t, rows) for t in (q, k, v, do))

    # 1. row statistics: m, l, d_row
    m, l = _tiled_row_stats(q, k, N, scale)

    def probs(j):     # p = dtype(exp(s - m) / l) of key stage j, 0 past N
        e = torch.exp(_stage_scores(q, k, j, N, scale) - m)
        return (e / l).to(dt).float()

    def dprobs(j):    # dp = f32(do . v)
        return do.float() @ _stage(v, j).float().transpose(-1, -2)

    if o is None:
        d_row = sum((probs(j) * dprobs(j)).sum(-1, keepdim=True)
                    for j in range(T))
    else:
        d_row = (do.float() * _pad_rows(o, rows).float()).sum(-1,
                                                              keepdim=True)
    # 2. dK and dV of each 64-key tile, walking the query stages with the
    # statistics as the scratch gives them (zeros past N, whose queries must
    # contribute nothing)
    past = (torch.arange(rows) >= N)[:, None]
    sm, sl, sd = (torch.where(past, 0.0, t) for t in (m, l, d_row))
    dk = torch.zeros(q.shape)
    dv = torch.zeros(q.shape)
    for kt in range(rows // TILE):
        keys = slice(kt * TILE, (kt + 1) * TILE)
        for i in range(T):
            qi = slice(i * STAGE, (i + 1) * STAGE)
            live = torch.arange(i * STAGE, (i + 1) * STAGE) < N
            st = (k[..., keys, :].float() @ q[..., qi, :].float()
                  .transpose(-1, -2)) * scale
            pt = (torch.exp(st - sm[..., qi, 0].unsqueeze(-2))
                  / sl[..., qi, 0].unsqueeze(-2)).to(dt).float()
            pt = torch.where(live, pt, 0.0)
            dpt = v[..., keys, :].float() @ do[..., qi, :].float() \
                .transpose(-1, -2)
            dst = (pt * (dpt - sd[..., qi, 0].unsqueeze(-2))
                   * scale).to(dt).float()
            dv[..., keys, :] += pt @ do[..., qi, :].float()
            dk[..., keys, :] += dst @ q[..., qi, :].float()
    # 3. dQ of each query row, walking the key stages
    dq = torch.zeros(q.shape)
    for j in range(T):
        ds = (probs(j) * (dprobs(j) - d_row) * scale).to(dt).float()
        dq = dq + ds @ _stage(k, j).float()
    return tuple(g[..., :N, :].to(dt) for g in (dq, dk, dv))


def _heads_view(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)                   # [B, N, H, D] <-> [B, H, N, D]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [65, 197, 600])
def test_tiled_cores_match_pallas(N, dtype):
    """The strided instantiations (divide after p . v; d_row from the saved
    output), emulated in tiles, against the Pallas fused_attention and the
    three gradients of its VJP, which takes N = 600 as it is."""
    B, H, D = 1, 2, 64
    rng = np.random.default_rng(N + 1)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _both(_normal(rng, (B, N, H, D)), dtype) for _ in range(4))
    out, vjp = jax.vjp(J.fused_attention, jq, jk, jv)
    grads = vjp(jdo)
    scale = D ** -0.5
    heads = [_heads_view(t) for t in (tq, tk, tv)]
    ours = tiled_forward(*heads, scale, divide_before=False)
    _close(_heads_view(ours), out, dtype, "out", max_rel=True)
    _, tout = _both(_np(out), dtype)
    for name, a, r in zip(("dq", "dk", "dv"), tiled_backward(
            *heads, _heads_view(tdo), scale, o=_heads_view(tout)), grads):
        _close(_heads_view(a), r, dtype, name, max_rel=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [65, 197, 600])
def test_tiled_block_core_matches_plain_twins(N, dtype):
    """The block instantiations (p = dtype(e / l) before p . v; d_row = sum_j
    p_j dp_j in the backward's phase 1), emulated in tiles, against the core
    of block_attention_plain / block_attention_bwd_plain (core_plain, whose
    o is the f32 p . v, and core_bwd_plain, whose d_row reads that o)."""
    B, H, D = 1, 2, 64
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(N + 2)
    q, k, v, do = (torch.from_numpy(_normal(rng, (B, H, N, D))).to(tdt)
                   for _ in range(4))
    scale = D ** -0.5
    p, o = core_plain(q, k, v, scale)
    _close(tiled_forward(q, k, v, scale, divide_before=True), o.to(tdt),
           dtype, "o", max_rel=True)
    ref = core_bwd_plain(q, k, v, p, o, do, scale)
    for name, a, r in zip(("dq", "dk", "dv"),
                          tiled_backward(q, k, v, do, scale), ref):
        _close(a, r.to(tdt), dtype, name, max_rel=True)


# --- the modules ------------------------------------------------------------

def _rel_l2(a, r) -> float:
    a, r = _np(a).astype(np.float64), _np(r).astype(np.float64)
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse_qkv", [True, False])
def test_attention_module_matches_jax(fuse_qkv, dtype):
    """The standalone Attention (no LayerNorm, no residual) at C = 128, 2
    heads, N = 50: forward in dtype; in f32 also dx and the four parameter
    gradients of sum(out * g), g seeded."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 50, 128))
    g = _normal(rng, (2, 50, 128))
    att = JaxAttention(2, dtype=jdt, fuse_qkv=fuse_qkv)
    with force_pallas_kernels():
        params = att.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = seeded_params(params, seed=4)
        loss = lambda p, x: jnp.sum(att.apply({"params": p}, x)
                                    .astype(jnp.float32) * g)
        ref = att.apply({"params": params}, jnp.asarray(x).astype(jdt))
        jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    mod = Attention(128, 2, fuse_qkv=fuse_qkv)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in
                         attention_state_from_flax(params).items()},
                        strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = mod(tx.to(tdt))
    assert out.dtype == tdt
    _close(out, ref, dtype, "out")
    if dtype != "float32":
        return
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = {"x": (tx.grad, jgx)}
    for k, v in attention_state_from_flax(jgp).items():
        grads[k] = (dict(mod.named_parameters())[k].grad, v)
    for name, (a, r) in grads.items():
        assert _rel_l2(a, r) <= GRAD_REL_L2, (name, _rel_l2(a, r))


def _tiny_unfused(dtype: str, seed: int):
    """A tiny JAX ViT(fuse_qkv=False) with seeded weights and the port's
    ViT(fuse_qkv=False) loaded from it, strict."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(seed).normal(size=(2, 16, 16, 3)) \
        .astype(np.float32)
    jax_vit = JaxViT(dtype=jdt, fuse_qkv=False, **TINY)
    with force_pallas_kernels():
        params = jax_vit.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = seeded_params(params, seed=seed + 1)
    vit = ViT(img_size=16, dtype=tdt, fuse_qkv=False, **TINY)
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in
                         vit_state_from_flax(params, prefix="").items()},
                        strict=True)
    return jax_vit, params, vit, x


def test_unfused_vit_tree_is_the_fused_one():
    """fuse_qkv changes no parameter: the JAX trees of both trunks have the
    same paths and shapes, so one state_dict loads into either port trunk."""
    x = jnp.zeros((1, 16, 16, 3))
    with force_pallas_kernels():
        trees = [jax.tree_util.tree_map(jnp.shape, JaxViT(
            fuse_qkv=f, **TINY).init(jax.random.PRNGKey(0), x)["params"])
            for f in (True, False)]
    assert trees[0] == trees[1]
    _, params, _, _ = _tiny_unfused("float32", seed=0)
    ViT(img_size=16, **TINY).load_state_dict(
        {k: torch.from_numpy(v) for k, v in
         vit_state_from_flax(params, prefix="").items()}, strict=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_unfused_vit_matches_jax(dtype):
    jax_vit, params, vit, x = _tiny_unfused(dtype, seed=0)
    with force_pallas_kernels():
        ref = jax_vit.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        ours = vit.eval()(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and ours.shape == (2, 32)
    _close(ours, ref, dtype, "pooled")


def test_tiny_unfused_vit_sgd_step_matches_jax():
    """One SGD step (lr 0.1) on sum(pooled * g) in f32: every parameter's
    update against jax.grad's, relative L2 <= 2e-2 per tensor."""
    jax_vit, params, vit, x = _tiny_unfused("float32", seed=20)
    g = np.random.default_rng(21).normal(size=(2, 32)).astype(np.float32)
    lr = 0.1
    with force_pallas_kernels():
        jgrads = jax.grad(lambda p: jnp.sum(jax_vit.apply(
            {"params": p}, jnp.asarray(x)) * g))(params)
    ref = vit_state_from_flax(jgrads, prefix="")
    before = {k: v.detach().clone() for k, v in vit.named_parameters()}
    opt = torch.optim.SGD(vit.parameters(), lr=lr)
    (vit.train()(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    opt.step()
    assert set(ref) == set(before)
    for name, p in vit.named_parameters():
        update = (before[name] - p.detach()) / lr
        assert _rel_l2(update, ref[name]) <= GRAD_REL_L2, (
            name, _rel_l2(update, ref[name]))
