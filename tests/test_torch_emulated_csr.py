"""The CUDA CSR scalar sum's own source, run on the CPU.

artgraph_tpu_torch/ops/attention_emulation.py compiles ops/csrc/csr_segment.cu
with g++ as host code and runs each block as one host thread per CUDA
thread. Here the two passes of
`ag_csr_scalar_sum_f32` over a CSR's chunk plan (scalar_sequence: a group
of lanes per chunk, then one warp per hub over its partials) are held
against `scalar_segment_sum_plain` in f64 at rtol = 1e-4, atol = 1e-3 (the
CSR kernels' bound on the card), a second call bit-identical to the first,
on segments of 0, 1, 255, 256 and 257 edges (around one chunk of 256),
31,250 and 55,556 (the benchmark graph's `style` and `genre` hubs), an
all-empty CSR, and short segments (the reverse relations, 4 lanes a
chunk), and at every group width. tests/test_torch_cuda.py holds the
compiled kernels on the card. The emulated tests skip where g++ is
missing.
"""
import shutil

import numpy as np
import pytest

from artgraph_tpu_torch.ops import attention_emulation, csr_segment

MIXED = [0, 1, 255, 256, 257, 31250, 0, 55556, 3]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    return attention_emulation.build(tmp_path_factory.mktemp("emulate"))


@pytest.mark.parametrize("counts", [[0], [1], [255], [256], [257], [31250],
                                    [55556], MIXED, [0, 0, 0], [],
                                    list(np.random.default_rng(0).integers(
                                        0, 21, 400))],
                         ids=["0", "1", "255", "256", "257", "31250",
                              "55556", "mixed", "all-empty", "none",
                              "short"])
def test_emulated_scalar_sum_matches_plain(emulated, counts):
    assert attention_emulation.check_csr_scalar(emulated, counts) <= 1.0


@pytest.mark.parametrize("lanes", csr_segment.SCALAR_LANES)
def test_emulated_scalar_sum_at_every_width(emulated, lanes):
    """Every group width covers every edge of every chunk, the hubs' too."""
    assert attention_emulation.check_csr_scalar(emulated, MIXED,
                                                lanes) <= 1.0


@pytest.mark.parametrize("counts,lanes", [([10] * 100, 4), ([32] * 10, 4),
                                          ([33] * 10, 16), ([128] * 10, 16),
                                          ([129] * 10, 32), ([200] * 10, 32),
                                          ([31250] * 4, 32), ([0, 0], 4)])
def test_scalar_lanes_follow_the_shape(counts, lanes):
    """4 lanes a chunk where the chunks average at most 32 edges, 16 up to
    128, else 32 (one round of 8 loads a lane covers the mean chunk); the
    same on every build of the same shape."""
    csr = attention_emulation.csr_from_counts(counts)
    assert csr.scalar_lanes == lanes
    assert csr.scalar_lanes == csr_segment.scalar_lanes(csr.num_edges,
                                                        csr.num_chunks)
