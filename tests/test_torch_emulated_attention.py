"""The CUDA attention cores' own source, run on the CPU.

artgraph_tpu_torch/ops/emulation.py compiles ops/csrc/
block_attention.cu and block_attention_bwd.cu with g++ as host code, with
warp-cooperative host versions of cp.async, ldmatrix and mma.sync, and runs
each block as one host thread per CUDA thread. Here the kernels' four paths
(strided and packed forward, saved-o and recomputed-o backward) are held
against their plain twins at the card's tolerance, rtol = atol = 3e-2: a
tile shorter than a stage, a full tile, a ragged last tile with two heads,
and three tiles on two images. This checks the kernels' indexing, fragment
layouts, masks and phases; tests/test_torch_cuda.py holds the compiled
kernels on the card. The windowed cores of Swin's blocks
(`ag_window_attention_bf16`, `ag_window_attention_bwd_bf16`) likewise, at
head dim 32 with and without the relative-position bias and the shift
mask, forward and backward with dBias (at relative L2 <= 2e-2,
bit-identical on a second call), at N = 144 (Swin's 12x12 windows: 9
warps), N = 80, N = 49 (odd: the bias, region and dBias accesses one
element at a time, a ragged last chunk) and N = 160 (10 warps), runs of 2
and 3 windows a block (the two-slot ring, dBias summed on chip across a
run); and ViT's D = 64 cores give the same bits as before the head dim
became a template parameter. Skips where g++ is missing.
"""
import hashlib
import shutil

import pytest
import torch

from artgraph_tpu_torch.ops import emulation


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation of the kernels")
    return emulation.build(tmp_path_factory.mktemp("emulate"))


@pytest.mark.parametrize("B,N,H", [(1, 17, 1), (1, 64, 1), (1, 65, 2),
                                   (2, 150, 1)])
def test_emulated_attention_kernels_match_plain(emulated, B, N, H):
    assert emulation.check(emulated, B, N, H) <= 1.0


# (B, N, H, nW, bias, mask) at 2 windows a run, each with the id its tuple
# gives; then a run of 3 windows at N = 144 (the dBias run summed on chip
# across three windows) and N = 160 (10 warps, the 10-chunk build)
WINDOW_CASES = [(3, 144, 1, 3, True, True), (3, 144, 1, 1, False, False),
                (2, 80, 2, 2, True, True), (2, 80, 2, 1, True, False),
                (2, 80, 1, 2, False, True), (2, 49, 1, 2, True, True)]


@pytest.mark.parametrize("B,N,H,nW,bias,mask,per_run", [
    *(pytest.param(*case, 2, id="-".join(map(str, case)))
      for case in WINDOW_CASES),
    pytest.param(3, 144, 1, 3, True, True, 3, id="3-144-1-3-True-True-run3"),
    pytest.param(2, 160, 1, 2, True, True, 2, id="2-160-1-2-True-True")])
def test_emulated_window_cores_match_plain(emulated, B, N, H, nW, bias,
                                           mask, per_run):
    assert emulation.check_window(emulated, B, N, H, nW, bias,
                                            mask, per_run) <= 1.0


# SHA-256 of ViT's cores' emulated outputs (bf16 bits) on window_inputs(2,
# 65, 2, 64) at seed 0, from the kernel sources before the head dim became
# a template parameter: packed forward, packed backward dqkv, strided
# forward, strided backward (dq, dk, dv stacked). A g++ build of those
# sources gives these digests with the same C library's expf.
VIT_DIGESTS = {
    "packed forward":
        "c6e17d1a28354910c8f564ea0c3f2a0090a3164c5e73e1fd5c32540a05573bce",
    "packed backward":
        "b9440c855949a117ae9e048bacb0695d45d91132d617167b326882b7cb4cd819",
    "strided forward":
        "1a53521643465c7d5072b836d68b0203cafbd8470710fd77d213a73479187f73",
    "strided backward":
        "a877bc9eeb9a0a162f78dcf1e32e4a07e536e2975c255065ca86a4b3b2177703",
}


def _digest(t: torch.Tensor) -> str:
    assert torch.isfinite(t.float()).all()
    return hashlib.sha256(t.view(torch.int16).numpy().tobytes()).hexdigest()


def test_emulated_d64_cores_are_vits_unchanged(emulated):
    """ViT's D = 64 cores, which the template instantiates at D = 64, give
    the bits they gave before (VIT_DIGESTS), and still match their twins."""
    B, N, H = 2, 65, 2
    C, scale = 64 * H, 64 ** -0.5
    assert emulation.check(emulated, B, N, H) <= 1.0
    qkv, do, _, _ = emulation.window_inputs(B, N, H, 64, 1, False,
                                                      False)
    packed, dout = qkv.reshape(B * N, 3 * C), do.reshape(B * N, C)
    base = packed.data_ptr()
    out = torch.full((B * N, C), float("nan"), dtype=torch.bfloat16)
    emulated.emu_attention(0, base, base + 2 * C, base + 4 * C,
                           out.data_ptr(), B, N, H, 3 * C, 3 * C, 3 * C, C,
                           scale)
    stats = torch.empty((3, B, H, N))
    dqkv = torch.full_like(packed, float("nan"))
    g = dqkv.data_ptr()
    emulated.emu_attention_bwd(0, base, base + 2 * C, base + 4 * C, None,
                               dout.data_ptr(), g, g + 2 * C, g + 4 * C,
                               stats.data_ptr(), B, N, H, 3 * C, 3 * C, 3 * C,
                               0, C, 3 * C, 3 * C, 3 * C, scale)
    q, k, v = qkv.unbind(2)
    o = torch.full((B, N, H, 64), float("nan"), dtype=torch.bfloat16)
    emulated.emu_attention(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), B, N, H, 3 * C, 3 * C, 3 * C, C,
                           scale)
    grads = [torch.full_like(o, float("nan")) for _ in range(3)]
    ts = (q, k, v, o, do, *grads)
    emulated.emu_attention_bwd(1, *(t.data_ptr() for t in ts),
                               stats.data_ptr(), B, N, H,
                               *(t.stride(1) for t in ts), scale)
    got = {"packed forward": _digest(out), "packed backward": _digest(dqkv),
           "strided forward": _digest(o),
           "strided backward": _digest(torch.stack(grads))}
    assert got == VIT_DIGESTS
