"""The CUDA attention cores' own source, run on the CPU.

artgraph_tpu_torch/ops/attention_emulation.py compiles ops/csrc/
block_attention.cu and block_attention_bwd.cu with g++ as host code, with
warp-cooperative host versions of cp.async, ldmatrix and mma.sync, and runs
each block as 128 host threads. Here the kernels' four paths (strided and
packed forward, saved-o and recomputed-o backward) are held against their
plain twins at the card's tolerance, rtol = atol = 3e-2: a tile shorter
than a stage, a full tile, a ragged last tile with two heads, and three
tiles on two images. This checks the kernels' indexing, fragment layouts,
masks and phases; tests/test_torch_cuda.py holds the compiled kernels on
the card. Skips where g++ is missing.
"""
import shutil

import pytest

from artgraph_tpu_torch.ops import attention_emulation


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    return attention_emulation.build(tmp_path_factory.mktemp("emulate"))


@pytest.mark.parametrize("B,N,H", [(1, 17, 1), (1, 64, 1), (1, 65, 2),
                                   (2, 150, 1)])
def test_emulated_attention_kernels_match_plain(emulated, B, N, H):
    assert attention_emulation.check(emulated, B, N, H) <= 1.0
