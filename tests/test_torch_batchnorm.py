"""The BatchNorm chain's autograd Functions (artgraph_tpu_torch.ops.batchnorm)
on their plain twins, against MixedBatchNorm's and the bottleneck's own
expressions (models/resnet.py), on the CPU.

On the card a CUDA bf16 channels-last input takes the kernels; here
`batchnorm.takes` is patched to take the CPU tensors too, so the model runs
the Functions with the twins where the card launches, beside the same
model on its plain path:

  * one MixedBatchNorm in train and eval mode, with and without the ReLU,
    from its own statistics and from a producer's raw sums: the output, the
    input's, gamma's, beta's and the raw sums' gradients, the running
    statistics and num_batches_tracked;
  * the bottleneck's tail with the identity and with a downsample, and the
    coefficients-only path (the unit's prologue) whose input gradient
    carries the statistics' own;
  * a ResNet50 of one block a stage, gate open and closed, train and eval:
    every output, gradient and buffer, and the number of launches each
    kernel would make (the twins' calls), reckoned from the architecture;
  * the data-parallel route: the raw sums (and n) summed over the ranks
    before the finishing, and (c1, c2) after the backward's finishing, as
    `psum`'s forward and backward do on the plain path;
  * the Functions free their graph once nothing holds their outputs;
  * the grid's runs cover the rows.

Twin and plain path differ only in the order of the sums: bf16 outputs and
input gradients at rtol = atol = 3e-2, f32 gradients and statistics at
relative L2 <= 1e-3 (each far below a wrong rounding point or formula,
which moves them by O(1)).
"""
import contextlib
import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from artgraph_tpu_torch.models import resnet
from artgraph_tpu_torch.models.resnet import (Bottleneck, MixedBatchNorm,
                                              ResNet50, bn_psum_axis)
from artgraph_tpu_torch.ops import batchnorm

torch.set_num_threads(2)

REL_L2 = 1e-3
STEPS = ("_stats", "_finish", "_apply", "_colsum", "_finish_bwd", "_dx")


def _on_cpu(t):
    """batchnorm.takes with the device condition left out."""
    return (t.dtype == torch.bfloat16 and t.dim() == 4
            and t.shape[1] % 8 == 0
            and t.is_contiguous(memory_format=torch.channels_last))


@contextlib.contextmanager
def _kernel_path(monkeypatch):
    """Route CPU tensors through the Functions; yields the twins' calls by
    step (the merge-only finishing not counted)."""
    calls = dict.fromkeys(STEPS, 0)
    with monkeypatch.context() as m:
        m.setattr(batchnorm, "takes", _on_cpu)
        for name in STEPS:
            def spy(*args, _f=getattr(batchnorm, name), _n=name):
                if _n != "_finish" or args[0] != batchnorm.FIN_MERGE:
                    calls[_n] += 1
                return _f(*args)
            m.setattr(batchnorm, name, spy)
        yield calls


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, MixedBatchNorm):
            C = m.weight.shape[0]
            m.weight.data = 1.0 + 0.2 * torch.randn(C, generator=g)
            m.bias.data = 0.2 * torch.randn(C, generator=g)
            m.running_mean.data = 0.1 * torch.randn(C, generator=g)
            m.running_var.data = 1.0 + 0.1 * torch.rand(C, generator=g)
    return module


def _bf16_nchw(shape, seed, scale=1.0, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    t = shift + scale * torch.randn(shape, generator=g)
    return t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _rel(ours, ref):
    ours, ref = ours.double(), ref.double()
    return ((ours - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _assert_same(ours, ref, name):
    assert ours.dtype == ref.dtype and ours.shape == ref.shape, name
    if ours.dtype == torch.bfloat16:
        torch.testing.assert_close(ours.float(), ref.float(), rtol=3e-2,
                                   atol=3e-2, msg=name)
    elif ours.dtype == torch.long:
        assert torch.equal(ours, ref), name
    else:
        assert _rel(ours, ref) <= REL_L2, (name, _rel(ours, ref))


def _assert_modules_same(ours, ref):
    for (name, p), q in zip(ref.named_parameters(), ours.parameters()):
        _assert_same(q.grad, p.grad, f"{name}.grad")
    for (name, b), c in zip(ref.named_buffers(), ours.buffers()):
        _assert_same(c, b, name)


def _both(module, run, monkeypatch):
    """(plain, kernel path): run(copy of module) on each path."""
    plain = run(copy.deepcopy(module))
    with _kernel_path(monkeypatch) as calls:
        fused = run(copy.deepcopy(module))
    return plain, fused, calls


@pytest.mark.parametrize("train,relu,raw", [
    (True, False, False), (True, True, False), (True, True, True),
    (False, False, False), (False, True, False)])
def test_batchnorm_function_matches_mixed_batchnorm(train, relu, raw,
                                                    monkeypatch):
    C = 64
    x = _bf16_nchw((3, C, 7, 5), 1, scale=2.0, shift=0.5)
    g = _bf16_nchw((3, C, 7, 5), 2)
    xf = x.float()
    sums = (xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)), 3 * 7 * 5.0)

    def run(bn):
        bn.train(train)
        xi = x.clone().requires_grad_()
        s1, s2 = (s.clone().requires_grad_() for s in sums[:2])
        y = bn(xi, raw_moments=(s1, s2, sums[2]) if raw else None, relu=relu)
        (y.float() * g.float()).sum().backward()
        return bn, y, xi.grad, s1.grad, s2.grad

    (bn, *ref), (bn_k, *ours), calls = _both(
        _randomize(MixedBatchNorm(C), 3), run, monkeypatch)
    assert calls["_apply"] == 1 and calls["_dx"] == 1
    assert calls["_stats"] == (train and not raw)
    for name, o, r in zip(("y", "dx", "ds1", "ds2"), ours, ref):
        if r is None:
            assert o is None, name
        else:
            _assert_same(o, r, name)
    _assert_modules_same(bn_k, bn)


@pytest.mark.parametrize("downsample,gate,train", [
    (False, False, True), (True, False, True), (True, True, True),
    (False, True, True), (True, False, False)])
def test_bottleneck_tail_matches_its_expressions(downsample, gate, train,
                                                 monkeypatch):
    """The tail (bn3 from conv3's own statistics or the unit's raw sums,
    the downsample's BatchNorm or the identity, the f32 add, the ReLU) and
    bn2's coefficients-only path under the unit's gate."""
    if gate:
        monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    else:
        monkeypatch.delenv("ARTGRAPH_CONVBN", raising=False)
    inplanes = 64 if downsample else 128
    block = _randomize(Bottleneck(inplanes, 32, stride=1,
                                  downsample=downsample), 4)
    x = _bf16_nchw((2, inplanes, 6, 6), 5)
    g = _bf16_nchw((2, 128, 6, 6), 6)

    def run(b):
        b.train(train)
        xi = x.clone().requires_grad_()
        y = b(xi)
        (y.float() * g.float()).sum().backward()
        return b, y, xi.grad

    (b, y, dx), (b_k, y_k, dx_k), calls = _both(block, run, monkeypatch)
    _assert_same(y_k, y, "y")
    _assert_same(dx_k, dx, "dx")
    _assert_modules_same(b_k, b)
    # bn1 and the tail apply; bn2 applies in the unit's prologue
    assert calls["_apply"] == (2 if gate and train else 3)
    assert calls["_colsum"] == calls["_apply"]


def _counts(blocks, downsamples, gate, train):
    """The launches of each kernel in one step of a ResNet50 trunk with
    `blocks` bottlenecks, `downsamples` of them with a downsample."""
    bns = 1 + 3 * blocks + downsamples
    if not train:
        return dict.fromkeys(STEPS, 0) | {"_finish": bns,
                                          "_apply": 1 + 3 * blocks}
    applies = 1 + (2 if gate else 3) * blocks
    return {"_stats": 1 + downsamples + (1 if gate else 3) * blocks,
            "_finish": bns, "_apply": applies, "_colsum": applies,
            "_finish_bwd": bns, "_dx": 1 + 3 * blocks}


@pytest.mark.parametrize("gate,train", [(True, True), (False, True),
                                        (False, False)])
def test_resnet_trunk_through_the_kernel_path(gate, train, monkeypatch):
    """ResNet50 of one bottleneck a stage on both paths: the pooled
    feature, the input's gradient, every parameter's gradient and every
    buffer; each kernel's launches as reckoned (for stage sizes (3, 4, 6,
    3) the same count gives 21 statistics, 53 finishing and 33 apply
    launches forward, 33, 53 and 49 backward, with the gate open)."""
    if gate:
        monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    else:
        monkeypatch.delenv("ARTGRAPH_CONVBN", raising=False)
    trunk = _randomize(ResNet50(stage_sizes=(1, 1, 1, 1)), 7)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))

    def run(m):
        m.train(train)
        xi = x.clone().requires_grad_()
        y = m(xi)
        if train:
            y.square().sum().backward()
        return m, y, xi.grad

    (m, y, dx), (m_k, y_k, dx_k), calls = _both(trunk, run, monkeypatch)
    _assert_same(y_k, y, "feature")
    if train:
        _assert_same(dx_k, dx, "dx")
        _assert_modules_same(m_k, m)
    else:
        for (name, b), c in zip(m.named_buffers(), m_k.buffers()):
            assert torch.equal(b, c), name
    assert calls == _counts(4, 4, gate, train)
    assert _counts(16, 4, True, True) == {
        "_stats": 21, "_finish": 53, "_apply": 33, "_colsum": 33,
        "_finish_bwd": 53, "_dx": 49}


class _TwoRanks(torch.autograd.Function):
    """psum over two ranks that hold the same tensor: 2x each way."""

    @staticmethod
    def forward(ctx, x):
        return 2.0 * x

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


@pytest.mark.parametrize("gate", [True, False])
def test_data_parallel_route_sums_before_finishing(gate, monkeypatch):
    """Under bn_psum_axis the kernel path sums (s1, s2, n) over the ranks
    between the statistics and the finishing, and (c1, c2) between the
    backward's finishing and dx: one [2C + 1] buffer each way a BatchNorm,
    the same numbers as the plain path's psum, the running variance's
    n / (n - 1) from the summed n."""
    if gate:
        monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    else:
        monkeypatch.delenv("ARTGRAPH_CONVBN", raising=False)
    seen = []

    def psum(x, axis_name):
        assert axis_name == "data"
        seen.append((torch.is_grad_enabled(), x.shape[0]))
        return _TwoRanks.apply(x)

    monkeypatch.setattr(resnet, "psum", psum)
    block = _randomize(Bottleneck(64, 32, stride=2, downsample=True), 9)
    x = _bf16_nchw((2, 64, 8, 8), 10)
    g = _bf16_nchw((2, 128, 4, 4), 11)

    def run(b):
        b.train()
        seen.clear()
        xi = x.clone().requires_grad_()
        with bn_psum_axis("data"):
            y = b(xi)
        (y.float() * g.float()).sum().backward()
        return b, y, xi.grad, list(seen)

    (b, y, dx, plain), (b_k, y_k, dx_k, fused), _ = _both(block, run,
                                                          monkeypatch)
    _assert_same(y_k, y, "y")
    _assert_same(dx_k, dx, "dx")
    _assert_modules_same(b_k, b)
    widths = [2 * c + 1 for c in (32, 32, 128, 128)]
    # the plain path: one psum a BatchNorm, recorded for autograd
    assert sorted(plain) == sorted((True, w) for w in widths)
    # the kernels: each forward's sum, then the backward's (bn3's first)
    assert sorted(fused[:4]) == sorted((False, w) for w in widths)
    assert sorted(fused[4:]) == sorted(fused[:4])
    # the summed n (2 x 32 rows) in the running variance
    assert not torch.equal(b_k.bn3.running_var,
                           _single_rank_running_var(block, x))


def _single_rank_running_var(block, x):
    b = copy.deepcopy(block).train()
    b(x.clone())
    return b.bn3.running_var


@pytest.mark.parametrize("gate", [True, False])
def test_functions_free_their_graph(gate, monkeypatch):
    """After a step's backward, dropping the output frees every tensor of
    the step (no reference cycle through a Function's ctx)."""
    if gate:
        monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    else:
        monkeypatch.delenv("ARTGRAPH_CONVBN", raising=False)
    block = _randomize(Bottleneck(64, 16, downsample=True), 13).train()
    x = _bf16_nchw((2, 64, 4, 4), 14)
    refs = []
    with _kernel_path(monkeypatch):
        xi = x.clone().requires_grad_()
        y = block(xi)
        refs.append(weakref.ref(y))
        for m in (block.bn1, block.bn2):
            m.register_forward_hook(lambda mod, inp, out: refs.extend(
                weakref.ref(t) for t in (out if isinstance(out, tuple)
                                         else (out,))))
        y = block(xi)
        refs.append(weakref.ref(y))
        y.float().sum().backward()
        del y, xi
    gc.collect()
    assert len(refs) >= 4 and all(r() is None for r in refs)


@pytest.mark.parametrize("M,C", [(401408, 64), (100352, 256), (25088, 512),
                                 (6272, 1024), (1568, 2048), (300, 64),
                                 (1, 8), (77, 96), (130, 2048)])
def test_row_chunks_cover_the_rows(M, C):
    per, runs = batchnorm.row_chunks(M, C)
    tiles = -(-C // (8 * batchnorm.MAX_LANES))
    assert (runs - 1) * per < M <= runs * per
    assert runs == 1 or per >= batchnorm.MIN_ROWS
    assert runs * tiles <= max(batchnorm.TARGET_BLOCKS, tiles)
    if M >= batchnorm.TARGET_BLOCKS * batchnorm.MIN_ROWS:
        assert runs * tiles > batchnorm.TARGET_BLOCKS // 2


def test_modules_not_in_f32_raise_on_the_kernel_path(monkeypatch):
    """A BatchNorm whose parameters were cast to bf16 (module.bfloat16())
    on an input the kernels take raises before any launch, in train and in
    eval mode: the kernels take f32 parameters and statistics only, and no
    such input falls back to the plain path unseen. The same module on an
    input they do not take (NCHW-contiguous) runs MixedBatchNorm's own
    expressions."""
    bn = _randomize(MixedBatchNorm(64), 15).bfloat16()
    x = _bf16_nchw((2, 64, 4, 4), 16)
    with _kernel_path(monkeypatch) as calls:
        for mode in (True, False):
            with pytest.raises(ValueError, match="weight must be"):
                bn.train(mode)(x, relu=True)
        assert bn.train()(x.contiguous(), relu=True).dtype == torch.bfloat16
    assert not any(calls.values())


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """Without the patch, CPU tensors never reach the Functions: takes()
    asks for CUDA."""
    x = _bf16_nchw((2, 64, 4, 4), 12)
    assert not batchnorm.takes(x)
    for name in STEPS:
        monkeypatch.setattr(batchnorm, name, None)   # any call would raise
    bn = MixedBatchNorm(64).train()
    assert bn(x, relu=True).dtype == torch.bfloat16
