"""The fused 1x1-conv + BN-statistics unit of the port
(artgraph_tpu_torch.ops.conv_bn) against the JAX package's
`conv1x1_bn_stats`, whose Pallas kernels run interpreted on the CPU as
tests/test_conv_bn_kernel.py runs them.

  * the plain twins' forward (y, s1, s2) and the gradients of (x, a, b, w)
    under seeded cotangents on all three outputs, with and without the
    prologue: f32 at rtol 1e-4 (order of accumulation only), bf16 at the
    3e-2 bound of the port's other bf16 kernels, relative to the scale of
    each output;
  * backward() through the autograd Function on CPU tensors gives exactly
    the plain backward, launches no kernel, and counts a cotangent autograd
    leaves undefined as zeros;
  * the weight-gradient split covers M in chunks of the GEMM's k step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu.ops.conv_bn import conv1x1_bn_stats as jax_unit
from artgraph_tpu_torch.ops import conv_bn

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
M, K, N = 96, 64, 32


def unit_inputs(M, K, N, seed):
    """x [M, K], a, b [K], w [N, K] (torch layout) and cotangents dy [M, N],
    ds1, ds2 [N], as numpy f32."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(rng.normal(size=(M, K))),
            f32(rng.normal(size=K) * 0.5 + 1.0), f32(rng.normal(size=K) * 0.1),
            f32(rng.normal(size=(N, K)) / np.sqrt(K)),
            f32(rng.normal(size=(M, N))), f32(rng.normal(size=N) * 0.1),
            f32(rng.normal(size=N) * 0.01))


def _close(ours, ref, tol, name):
    """allclose at rtol = tol with atol = tol * mean|ref|."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, name
    np.testing.assert_allclose(ours, ref, rtol=tol,
                               atol=tol * np.abs(ref).mean(), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", [False, True])
def test_plain_twins_match_jax_unit(prologue, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, a, b, w, dy, ds1, ds2 = unit_inputs(M, K, N, seed=int(prologue))
    jargs = (jnp.asarray(x, jdt), jnp.asarray(a, jdt), jnp.asarray(b, jdt),
             jnp.asarray(w.T))
    (jy, js1, js2), vjp = jax.vjp(
        lambda *t: jax_unit(*t, prologue), *jargs)
    jgrads = vjp((jnp.asarray(dy, jdt), jnp.asarray(ds1), jnp.asarray(ds2)))

    tx, ta, tb = (torch.from_numpy(v).to(tdt) for v in (x, a, b))
    tw = torch.from_numpy(w)
    y, s1, s2 = conv_bn.conv1x1_bn_stats_plain(tx, ta, tb, tw, prologue)
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    for name, o, r in (("y", y, jy), ("s1", s1, js1), ("s2", s2, js2)):
        _close(o.float().numpy(), r, tol, name)
    grads = conv_bn.conv1x1_bn_stats_bwd_plain(
        tx, ta, tb, tw, y, torch.from_numpy(dy).to(tdt),
        torch.from_numpy(ds1), torch.from_numpy(ds2), prologue)
    assert [g.dtype for g in grads] == [tdt, tdt, tdt, torch.float32]
    for name, o, r in zip(("dx", "da", "db", "dw"), grads, jgrads):
        r = np.asarray(r, np.float32)
        if name == "dw":                   # JAX [K, N] -> torch [N, K]
            r = r.T
        if not prologue and name in ("da", "db"):
            assert not o.any() and not r.any(), name
            continue
        _close(o.float().numpy(), r, tol, name)


@pytest.mark.parametrize("prologue", [False, True])
def test_autograd_function_gives_plain_backward(prologue, monkeypatch):
    monkeypatch.setattr(conv_bn, "LAUNCHES", 0)
    monkeypatch.setattr(conv_bn, "LAUNCHES_BWD", 0)
    x, a, b, w, dy, ds1, ds2 = (torch.from_numpy(v) for v in
                                unit_inputs(M, K, N, seed=2))
    x, a, b = (t.to(torch.bfloat16) for t in (x, a, b))
    y, _, _ = conv_bn.conv1x1_bn_stats_plain(x, a, b, w, prologue)
    ref = conv_bn.conv1x1_bn_stats_bwd_plain(x, a, b, w, y, dy.bfloat16(),
                                             ds1, ds2, prologue)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, w)]
    out = conv_bn.conv1x1_bn_stats(*leaves, prologue)
    torch.autograd.backward(out, (dy.bfloat16(), ds1, ds2))
    for name, t, r in zip(("dx", "da", "db", "dw"), leaves, ref):
        assert t.grad.dtype == r.dtype, name
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0, msg=name)
    # only y reaches the loss: ds1 and ds2 are undefined, counted as zeros
    for t in leaves:
        t.grad = None
    out = conv_bn.conv1x1_bn_stats(*leaves, prologue)
    out[0].float().mul(dy).sum().backward()
    zero = torch.zeros(N)
    ref = conv_bn.conv1x1_bn_stats_bwd_plain(x, a, b, w, y, dy.bfloat16(),
                                             zero, zero, prologue)
    for name, t, r in zip(("dx", "da", "db", "dw"), leaves, ref):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0, msg=name)
    assert (conv_bn.LAUNCHES, conv_bn.LAUNCHES_BWD) == (0, 0)


@pytest.mark.parametrize("M,K,N", [(100352, 64, 64), (100352, 64, 256),
                                   (6272, 1024, 256), (1568, 512, 2048),
                                   (98, 64, 64), (1000, 96, 32)])
def test_weight_gradient_split_covers_the_rows(M, K, N):
    chunk, splits = conv_bn.dw_split(M, N, K)
    assert chunk % conv_bn.SPLIT_STEP == 0
    assert (splits - 1) * chunk < M <= splits * chunk
    tiles = -(-N // conv_bn.ROW_TILE) * -(-K // conv_bn.ROW_TILE)
    if M >= conv_bn.TARGET_BLOCKS * conv_bn.DW_MIN_CHUNK:
        assert splits * tiles >= conv_bn.TARGET_BLOCKS // 2


@pytest.mark.parametrize("M,K,N", [(100352, 64, 256), (6272, 1024, 256),
                                   (1568, 512, 2048), (1000, 96, 32),
                                   (98, 64, 1024)])
def test_input_gradient_split_covers_the_columns(M, K, N):
    """The input gradient's product splits its N columns only where its
    [M, K] tiles leave card slots empty (layer4's 1568 x 512: 52 tiles),
    in whole k steps of at least DZ_MIN_CHUNK columns."""
    chunk, splits = conv_bn.dz_split(M, N, K)
    tiles = -(-M // conv_bn.ROW_TILE) * -(-K // conv_bn.ROW_TILE)
    assert chunk % conv_bn.SPLIT_STEP == 0
    assert (splits - 1) * chunk < N <= splits * chunk
    assert splits == 1 or (tiles < conv_bn.TARGET_BLOCKS
                           and chunk >= conv_bn.DZ_MIN_CHUNK)
    if tiles >= conv_bn.TARGET_BLOCKS:
        assert splits == 1
    if (M, K, N) == (1568, 512, 2048):
        assert splits == 4
