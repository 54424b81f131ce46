"""The CUDA conv + BN-statistics unit's own source, run on the CPU.

artgraph_tpu_torch/ops/emulation.py compiles ops/csrc/conv_bn.cu
(its three products on the cp.async ring with ldmatrix and mma.sync, and the
fixed-order sums of sum_groups.cuh) with g++ as host code, with
warp-cooperative host versions of the PTX helpers, and runs each block as
256 host threads. Here the forward and backward launches, in the order and
grids of `ag_conv_bn_{fwd,bwd}_bf16`, are held against the plain twins at
the card's tolerances: y and dx at rtol = atol = 3e-2, the f32 sums and dw
at relative L2 <= 2e-2, da and db exactly zero without the prologue. The
shapes put M off the 128-row tile, split the weight gradient's rows into
several chunks and, in two of them, the input gradient's N (its DZ_PART
and DZ_SUM passes), and take K and N at 32 and 96 (a row tile partly
empty, a k-step count not a multiple of the ring). tests/test_torch_cuda.py
holds the compiled kernels on the card. Skips where g++ is missing.
"""
import shutil

import pytest

from artgraph_tpu_torch.ops import emulation


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    return emulation.build(tmp_path_factory.mktemp("emulate"))


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("M,K,N,chunk,dz_chunk", [(300, 96, 32, 96, None),
                                                  (130, 32, 96, 32, 32),
                                                  (200, 96, 96, None, 64)])
def test_emulated_conv_bn_kernels_match_plain(emulated, M, K, N, chunk,
                                              dz_chunk, prologue):
    assert emulation.check_conv_bn(emulated, M, K, N, prologue,
                                             chunk, dz_chunk) <= 1.0
