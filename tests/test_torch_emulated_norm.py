"""The CUDA LayerNorm backward and column sums' own source, run on the CPU.

artgraph_tpu_torch/ops/attention_emulation.py compiles
ops/csrc/block_norm_bwd.cu (the one-pass LayerNorm backward with the
residual bias's column sum, the bias column sums, and the fixed-order sums
of sum_groups.cuh) with g++ as host code and runs each block as one host
thread per CUDA thread. Here the launches of `ag_layernorm_bwd_bf16` and
`ag_colsum_bf16`, in their order and with the row splits of
ops/attention.py, are held against `ln_bwd_plain` and the f32 column sum at
the card's tolerances: dx at rtol = atol = 3e-2, dgamma, dbeta, db_res and
the column sums at relative L2 <= 2e-2, a second call bit-identical to the
first. The shapes put the rows off the blocks' runs (1, 17, 300, 394) and C
off the 256 columns of a warp's 16-byte loads (64, 192; 768 is ViT-B/16's
width, 2304 its dqkv's). tests/test_torch_cuda.py holds the compiled kernels
on the card. The emulated tests skip where g++ is missing; the row splits
are checked without it.
"""
import shutil

import pytest

from artgraph_tpu_torch.ops import attention, attention_emulation

ROWS = [1, 17, 300, 394]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    return attention_emulation.build(tmp_path_factory.mktemp("emulate"))


@pytest.mark.parametrize("cols", [64, 192, 768])
@pytest.mark.parametrize("rows", ROWS)
def test_emulated_layernorm_bwd_matches_plain(emulated, rows, cols):
    assert attention_emulation.check_norm(emulated, rows, cols) <= 1.0


@pytest.mark.parametrize("cols", [64, 192, 768, 2304])
@pytest.mark.parametrize("rows", ROWS)
def test_emulated_colsum_matches_plain(emulated, rows, cols):
    assert attention_emulation.check_colsum(emulated, rows, cols) <= 1.0


@pytest.mark.parametrize("rows", [1, 3, 17, 394, 1055, 1057, 6304, 6305,
                                  100352])
def test_norm_groups_cover_the_rows(rows):
    """Every row in exactly one block's run, every run non-empty and whole
    NORM_WARPS rows, about NORM_BLOCKS runs where the rows allow; the split
    is a function of the shape (the same on every call)."""
    per, groups = attention.norm_groups(rows)
    assert (per, groups) == attention.norm_groups(rows)
    assert per % attention.NORM_WARPS == 0
    assert (groups - 1) * per < rows <= groups * per
    assert groups <= attention.NORM_BLOCKS
    if rows >= attention.NORM_BLOCKS * attention.NORM_WARPS:
        assert groups > attention.NORM_BLOCKS // 2
    if rows == 6304:                    # ViT-B/16 at batch 32
        assert (per, groups) == (24, 263)


@pytest.mark.parametrize("rows,cols", [(1, 64), (17, 192), (394, 768),
                                       (6304, 768), (6304, 2304),
                                       (6304, 3072), (6305, 3072),
                                       (100352, 64)])
def test_colsum_groups_cover_the_rows(rows, cols):
    """Every row in exactly one chunk, every chunk non-empty and whole
    COLSUM_LANES rows, the grid near COLSUM_BLOCKS blocks where the rows
    allow; a function of the shape."""
    per, chunks = attention.colsum_groups(rows, cols)
    assert (per, chunks) == attention.colsum_groups(rows, cols)
    assert per % attention.COLSUM_LANES == 0
    assert (chunks - 1) * per < rows <= chunks * per
    blocks = chunks * -(-cols // attention.COLSUM_COLS)
    assert blocks <= max(attention.COLSUM_BLOCKS, -(-cols //
                                                    attention.COLSUM_COLS))
    if rows >= attention.COLSUM_BLOCKS * attention.COLSUM_LANES:
        assert blocks > attention.COLSUM_BLOCKS // 2
