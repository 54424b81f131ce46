"""The CUDA BatchNorm chain's own source, run on the CPU.

artgraph_tpu_torch/ops/emulation.py compiles
ops/csrc/batchnorm.cu with g++ as host code and runs each block as 256 (the
streaming kernels) or 512 (the finishing) host threads. Here its six entry
points, with the checks, grids and kernels that `ag_bn_*` launch, run
from the same inputs as their twins in ops/batchnorm.py: the statistics'
and the column sums' run partials, added, at relative L2 <= 1e-5 of the
twins' sums and bit-identical on a second call; the finishing (train, with
n on the host and on the device, eval, the merge of the runs' partials),
the apply, the backward's finishing (from the sums and from the unit's
bf16 da, db) and dx bit-identical to the twins, which round where
MixedBatchNorm's expressions round. The shapes put M off the runs (300 =
5 x 60, 77, 130) and take C at 64 (one tile of 8 lanes, 32 rows a step), 96
(12 lanes, four threads of a block idle) and 2048 (eight tiles of 256
channels), with the identity, without it, and with the downsample's
second branch. tests/test_torch_cuda.py holds the compiled kernels on the
card. Skips where g++ is missing.
"""
import shutil

import pytest

from artgraph_tpu_torch.ops import emulation


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    return emulation.build(tmp_path_factory.mktemp("emulate"))


@pytest.mark.parametrize("M,C,branches,identity", [
    (300, 64, 1, True), (300, 64, 1, False), (77, 96, 2, False),
    (130, 2048, 2, False), (130, 2048, 1, True)])
def test_emulated_batchnorm_kernels_match_plain(emulated, M, C, branches,
                                                identity):
    assert emulation.check_batchnorm(emulated, M, C, branches,
                                               identity) <= 1.0
