#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ViT-B/16 serving and training paths, its
KG-embedding stage (the hetero-GAT of train_gnn_embeddings), its ResNet50
serving and training paths, and the unfused ViT-B/16 trunk
(ViT(fuse_qkv=False)) and the standalone Attention module once on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

It imports nothing of JAX or of the JAX package; PIL only in the ViT and
ResNet CLI phases (data decode), pandas there and with the KG container of
the GNN phases. Phases, each printing its lines; any failure raises and exits
non-zero:

  1. device   the card (nvidia-smi name and power limit), torch/CUDA versions;
              no CUDA -> exit 1 before anything else
  2. build    nvcc-builds artgraph_tpu_torch/ops/csrc/*.cu (one nvcc per
              source, all at once) into build/artgraph_tpu_torch/ and loads it
  3. check    each kernel against its plain PyTorch version on the card at the
              main path's shapes (B=32, N=197, C=768, H=12, MLP 3072, bf16;
              inputs and the output gradient from a numpy seed): the block
              forwards at rtol = atol = 3e-2; the block backwards' dx at
              rtol = atol = 3e-2 and each f32 parameter gradient at relative
              L2 <= GRAD_REL_L2 and max|a-b| / mean|a| <= GRAD_MAX_REL (the
              JAX tests' bf16 gradient bound is 0.2), the K third of db_qkv
              (zero in exact arithmetic) by absolute error only, each
              bit-identical on repeat; the uint8 normalize bit-exact for
              both statistics
  4. time     each kernel, its plain version and one PyTorch library call for
              the same function (a yardstick the port never calls): median
              of 10 CUDA-event timings, each over 10 back-to-back calls;
              and each kernel's bound, the larger of its FLOPs at 989 TFLOP/s
              (bf16 dense) and its bytes at 3.35 TB/s, from the shapes
  5. serve    ViTSingleTask(32) and NewMultiModalMultiTaskViT(128, ...) at
              full ViT-B/16 width with seeded random weights, saved as
              reference .pt files and loaded back through
              load_reference_checkpoint; 3 batches of 32 uint8 images through
              cli.predict.infer on cuda. The launch counters, zeroed just
              before, must read 12*3, 12*3 and 3 per model; logits finite and,
              on 2 images, within relative L2 5e-2 of the f32 plain path on
              the CPU with the same weights; img/s printed.
  6. train    ViTSingleTask(32) at full width, seeded random weights, dropout
              0.4, Trainer with adam(3e-4) on cuda, one seeded batch of 32:
              2 warm-up steps, then 8 timed steps with the counters zeroed
              just before (12*8 forward and 12*8 backward launches per block
              kernel, 8 normalize launches); every loss finite, the last below
              the first; img/s, then 2 profiled steps for the device time by
              kernel and the idle share (busy time: kernels, memcpys and
              memsets; user-annotation spans left out and printed beside).
  7. grads    one step's gradients on 2 images (dropout 0): the kernels in
              bf16 on the card against the f32 plain path on the CPU with the
              same weights; relative L2 of the concatenated trunk gradient
              <= TRAIN_GRAD_REL_L2.
  8. cli      cli.train_baseline --architecture vit --device cuda, 1 epoch
              at --batch 8 on a synthetic class-structured ArtGraph tree
              (tests/_make_synth.py), with ARTGRAPH_CHECKPOINTS_DIR in a
              temporary directory: its train/valid/test lines, and its
              checkpoint reloaded with load_reference_checkpoint.
  9. gnn train  HeteroSGNN GATConv (hidden 128, out 32, 2 layers, BN,
              dropout 0.4, adam(0.01)) on cuda on the JAX package's GNN
              benchmark graph (bench.py:221-246, from a numpy seed): 100K
              artworks, 4 relations and their reverses of 1M edges each.
              2 warm-up steps, then 5 timed steps with the counters zeroed
              just before: the softmax kernel 3R per step (R = 8 relations),
              the sum and scalar kernels once per backward of a conv on a
              path to the loss, the weighted kernel never; losses finite
              and falling; edges/s, ms/step, peak memory, one eval forward,
              and 2 profiled steps.
 10. gnn grads  one train-mode step (dropout 0) on a reduced graph of the same
              schema: loss, artwork embeddings, the concatenated parameter
              gradient and the BN running statistics, kernels on cuda
              against the plain path in f32 on the CPU, at relative L2 <=
              GNN_GRAD_REL_L2.
 11. gnn cli  cli.train_gnn_embeddings --device cuda --epochs 6 on a small KG
              tree written here with pandas; its metric lines, and both
              embedding files reloaded ([n_artwork, 128], finite).

Phases 3 and 4 also hold the four CSR segment kernels (f32) against their
plain twins in f64 at rtol = 1e-4, atol = 1e-3, bit-identical from call to
call, at the benchmark graph's shapes, and time them (csr_kernel_phases);
and the fused 1x1-conv + BN-statistics unit, forward and backward, against
its plain twins on the card at three of ResNet50's shapes at batch 32
(M, K, N, prologue) = (100352, 64, 256, yes), (6272, 1024, 256, no),
(1568, 512, 2048, yes), dy a unit normal: y and dx at rtol = atol = 3e-2,
s1, s2, da, db, dw at relative L2 <= GRAD_REL_L2, bit-identical from call to
call; timed beside the plain twins and torch.matmul with the column sums
(conv_bn_kernel_phases); and the kernels of fused_attention and
fused_qkv_attention, forward and backward, at B=32, N=197, H=12, D=64 (q, k,
v strided views of one [B, N, 3, H, D] bf16 tensor, never copied; x
[B, N, 768]) against their plain twins on the card: outputs, dq/dk/dv and
dx at rtol = atol = 3e-2, the f32 dw and db as in phase 3 (the K third of
db by absolute error), bit-identical on repeat; fused_attention forward and
backward also at N = 600 on 2 images x 2 heads against the twins, the same
way; timed beside the twins and F.scaled_dot_product_attention (after
F.linear for the qkv op; autograd of the same for the backwards)
(attention_kernel_phases).

 12. resnet serve  ResnetSingleTask(32) and NewMultiModalMultiTask(128, ...)
              at full ResNet50 size with seeded weights, saved as reference
              .pt files and loaded through load_reference_checkpoint; 3
              batches of 32 through cli.predict.infer on cuda: the normalize
              counter 3 per model, the other kernels 0 (eval runs no unit);
              logits on 2 images within relative L2 5e-2 of the f32 CPU
              path; img/s over the 3 batches, then the median img/s of
              SERVE_WINDOWS windows of SERVE_WINDOW_BATCHES batches each.
 13. resnet train  ResnetSingleTask(32), dropout 0.4, adam(3e-4), batch 32 on
              cuda with ARTGRAPH_CONVBN=1: 2 warm-up steps, then 8 timed
              steps, 32 forward and 32 backward unit launches a step; losses
              finite and falling; img/s, peak memory, 2 profiled steps. Then
              the same steps from the same weights with the gate closed (no
              unit launch), img/s and the profile beside.
 14. resnet grads  one step on 4 images (dropout 0) with the unit in bf16 on
              the card, each of its 32 + 32 unit launches held against the
              plain twin on its own inputs at the kernel tolerances (y and
              dx with atol KERNEL_TOL x mean|ref|); against the unfused f32
              path on the CPU, same weights: loss, logits, head and trunk
              gradients and the BN statistics' updates, each at relative
              L2 <= max(
              TRAIN_GRAD_REL_L2, BF16_FLOOR_FACTOR x the unfused bf16 CPU
              path's own distance from the f32 one) (the random-init trunk's
              gradient is chaotic: resnet_grad_phase); then one ragged step
              (half the rows masked) on the card: no unit launch, and the BN
              statistics' updates against the CPU path over the valid rows.
 15. resnet cli  cli.train_baseline --architecture resnet --device cuda with
              ARTGRAPH_CONVBN=1, 1 epoch at --batch 10 (the last of the 24
              training images' batches ragged): its lines, the unit's
              launches on the full batches only, the checkpoint reloaded.
 16. vit unfused serve  the ViTSingleTask trunk of phase 5's weights loaded
              strict into ViT(fuse_qkv=False) at full ViT-B/16 width and
              depth (qkv Linear, fused_attention on strided q/k/v views,
              proj; LayerNorm, MLP and GELU in PyTorch); 3 batches of 32
              normalized images, eval: fused_attention 12 per batch, every
              other kernel 0; pooled features on 2 images within relative L2
              5e-2 of the f32 plain path on the CPU and of the fused-block
              trunk with the same weights; img/s.
 17. vit unfused train  phase 6 with the ViTSingleTask trunk replaced by
              ViT(fuse_qkv=False) (same weights): 2 warm-up and 8 timed
              steps, 12 forward and 12 backward fused_attention launches a
              step and no block-kernel launch; losses finite and falling;
              img/s and 2 profiled steps; then phase 7 on that trunk.
 18. attention module  the standalone Attention(768, 12, fuse_qkv=True)
              (the JAX package's attention_module_x12 profile): 12 forward +
              backward calls on x [32, 197, 768] bf16, 12 fused_qkv_attention
              launches each way; one call's dx and its four parameter
              gradients against the f32 plain path on the CPU at relative L2
              <= TRAIN_GRAD_REL_L2 (the K third of db_qkv by absolute error);
              ms per call.

Then one JSON line with the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The f32 plain references run with TF32 off for matmuls and cuDNN.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
B, N, C, H, HIDDEN = 32, 197, 768, 12, 3072
D = C // H
KERNEL_TOL = 3e-2          # bf16 bound of tests/test_mlp_kernel.py
GRAD_REL_L2 = 2e-2         # backward kernels vs plain, f32 parameter grads
GRAD_MAX_REL = 0.1         # max|a-b| / mean|a| (JAX tests' bf16 bound: 0.2)
E2E_REL_L2 = 5e-2
TRAIN_GRAD_REL_L2 = 5e-2   # one step's trunk gradient, bf16 card vs f32 CPU
BF16_FLOOR_FACTOR = 1.25   # ResNet50: at most this times plain bf16's error
SEED = 0
BATCHES = 3
# ResNet50 serving's img/s: the median of windows of this many batches
SERVE_WINDOWS, SERVE_WINDOW_BATCHES = 5, 10
TRAIN_WARMUP, TRAIN_STEPS, PROFILED_STEPS = 2, 8, 2
PEAK_FLOPS = 989e12        # H100 SXM bf16 dense
PEAK_F32 = 67e12           # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# the GNN stage at the JAX package's benchmark graph (bench.py:221-246)
GNN_ARTWORKS, GNN_EDGES = 100_000, 1_000_000
GNN_WARMUP, GNN_STEPS = 2, 5
CSR_RTOL, CSR_ATOL = 1e-4, 1e-3   # hub bound of tests/test_csr_segment.py:49
GNN_GRAD_REL_L2 = 1e-3     # one GNN step, kernels on cuda vs plain on the CPU
# the conv + BN-statistics unit at three of ResNet50's (M, K, N, prologue)
# shapes at batch 32; 16 bottlenecks, two units each
CONV_BN_SHAPES = ((100352, 64, 256, True), (6272, 1024, 256, False),
                  (1568, 512, 2048, True))
RESNET_UNITS = 32
# a sequence length past what a [64, N] score tile in shared memory allows
LONG_N = 600


def device_phase() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; "
                           "this script needs an NVIDIA GPU")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True).stdout.strip()
    except FileNotFoundError:
        smi = torch.cuda.get_device_name(0)
    print(smi)
    present = {m: importlib.util.find_spec(m) is not None
               for m in ("triton", "PIL", "pandas")}
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"installed {present}", flush=True)


def build_phase() -> None:
    from artgraph_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.lib()
    ptxas = [line.split("ptxas info    : ")[-1] for line in
             path.with_suffix(".log").read_text().splitlines()
             if "Used" in line]
    print(f"build: {seconds:.1f} s, {_build.nvcc_path()} -> "
          f"{path.relative_to(REPO)}; ptxas: {' | '.join(ptxas)}", flush=True)


def _errors(ours: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max of error / (atol + rtol |ref|)); the second <= 1
    is the allclose criterion."""
    err = (ours.float() - ref.float()).abs()
    bound = KERNEL_TOL + KERNEL_TOL * ref.float().abs()
    return err.max().item(), (err / bound).max().item()


def _check_output(name: str, ours: torch.Tensor, ref: torch.Tensor) -> float:
    """A bf16 output at rtol = atol = KERNEL_TOL; returns the max abs error."""
    max_abs, ratio = _errors(ours, ref)
    print(f"check: {name} {list(ref.shape)} bf16 vs plain: max abs "
          f"{max_abs:.4g}, worst err/(atol+rtol|ref|) {ratio:.4g}", flush=True)
    if not (ratio <= 1.0 and torch.isfinite(ours.float()).all()):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"beyond rtol=atol={KERNEL_TOL}")
    return max_abs


def _k_third(name: str, a: torch.Tensor, r: torch.Tensor) -> tuple:
    """A qkv bias gradient's K third, zero in exact arithmetic, held by
    absolute error against GRAD_MAX_REL * mean|r|; returns (its max abs
    error, a and r without it)."""
    scale = r.abs().mean().item()
    k_err = (a[C:2 * C] - r[C:2 * C]).abs().max().item()
    if not k_err <= GRAD_MAX_REL * scale:
        raise AssertionError(f"{name} db_qkv K third: {k_err} > "
                             f"{GRAD_MAX_REL} * {scale}")
    return (k_err, torch.cat((a[:C], a[2 * C:])),
            torch.cat((r[:C], r[2 * C:])))


def _check_param_grad(name: str, gname: str, a: torch.Tensor,
                      r: torch.Tensor, qkv_bias: bool = False) -> float:
    """An f32 parameter gradient at relative L2 <= GRAD_REL_L2 and
    max|a-b| / mean|a| <= GRAD_MAX_REL; for a qkv bias (qkv_bias) the K
    third, zero in exact arithmetic, by absolute error only. Returns the max
    abs error."""
    if a.dtype != torch.float32 or a.shape != r.shape:
        raise AssertionError(f"{name} {gname}: {a.dtype} {a.shape}")
    a, r = a.double(), r.double()
    max_abs = (a - r).abs().max().item()
    note = ""
    if qkv_bias:
        bound = GRAD_MAX_REL * r.abs().mean().item()
        k_err, a, r = _k_third(name, a, r)
        note = (f"; K third max abs {k_err:.4g} (<= "
                f"{GRAD_MAX_REL} * mean|db_qkv| = {bound:.4g})")
    rel_l2 = ((a - r).norm() / r.norm()).item()
    max_rel = ((a - r).abs().max() / r.abs().mean()).item()
    print(f"check: {name} {gname} {list(r.shape)} f32: rel L2 "
          f"{rel_l2:.4g}, max|a-b|/mean|a| {max_rel:.4g}{note}", flush=True)
    if not (rel_l2 <= GRAD_REL_L2 and max_rel <= GRAD_MAX_REL
            and torch.isfinite(a).all()):
        raise AssertionError(f"{name} {gname} disagrees with the plain "
                             f"backward (rel L2 {rel_l2}, max {max_rel})")
    return max_abs


def _check_grads(name: str, ours, ref) -> float:
    """dx, then each f32 parameter gradient (see phase 3); returns the max
    abs error over all of them."""
    max_abs = _check_output(f"{name} dx", ours[0], ref[0])
    names = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for gname, a, r in zip(names, ours[1:], ref[1:]):
        max_abs = max(max_abs, _check_param_grad(
            name, gname, a, r,
            qkv_bias=name == "fused_block_attention_bwd" and gname == "db1"))
    return max_abs


def _time_ms(fn, timings: int = 10, reps: int = 10, warmup: int = 3) -> float:
    """Median over `timings` CUDA-event intervals of ms per call, each
    interval spanning `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(timings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _bound(flops: float, nbytes: float,
           peak_flops: float = PEAK_FLOPS) -> tuple[float, str]:
    """(least ms, what bounds it): FLOPs at the type's peak (bf16 dense by
    default) or bytes (each input read once, each output written once) at
    the HBM rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bounds() -> dict:
    """Each kernel's bound from the main path's shapes."""
    M = B * N
    core = 2 * B * H * N * N * D                # one [N, N] x [N, D] product
    attn_fwd = 2 * M * C * 3 * C + 2 * core + 2 * M * C * C
    # recompute qkv and the core forward; do.W_proj; dv, dp, dq, dk;
    # dqkv.W_qkv, dW_qkv, dW_proj
    attn_bwd = (2 * M * C * 3 * C + 2 * core + 2 * M * C * C + 4 * core
                + 2 * (2 * M * 3 * C * C) + 2 * M * C * C)
    mlp_fwd = 2 * (2 * M * C * HIDDEN)
    mlp_bwd = 5 * (2 * M * C * HIDDEN)          # fc1, dact, dy, dW1, dW2
    act = M * C * 2                             # one bf16 [B, N, C] tensor
    attn_params = (3 * C * C + 3 * C + C * C + C + 2 * C) * 4
    mlp_params = (2 * C * HIDDEN + HIDDEN + C + 2 * C) * 4
    images = B * 224 * 224 * 3
    return {
        "fused_block_attention": _bound(attn_fwd, 2 * act + attn_params),
        "fused_block_mlp": _bound(mlp_fwd, 2 * act + mlp_params),
        "normalize_images": _bound(0, images * (1 + 4)),
        "fused_block_attention_bwd": _bound(attn_bwd,
                                            3 * act + 2 * attn_params),
        "fused_block_mlp_bwd": _bound(mlp_bwd, 3 * act + 2 * mlp_params),
    }


def _library_calls(x, do, attn_p, mlp_p, images):
    """One PyTorch composition per kernel, on bf16 copies of the weights
    made outside the timed call: the yardstick, never used by the port."""
    import torch.nn.functional as F

    from artgraph_tpu_torch.ops.preprocess import norm_coefficients

    bf = [[p.to(torch.bfloat16) for p in ps] for ps in (attn_p, mlp_p)]

    def attn(x, g, b, wq, bq, wp, bp):
        qkv = F.linear(F.layer_norm(x, (C,), g, b, 1e-6), wq, bq)
        q, k, v = qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return x + F.linear(o.transpose(1, 2).reshape(B, N, C), wp, bp)

    def mlp(x, g, b, w1, b1, w2, b2):
        h = F.gelu(F.linear(F.layer_norm(x, (C,), g, b, 1e-6), w1, b1))
        return x + F.linear(h, w2, b2)

    def grad(fn, params):
        leaves = [p.detach().requires_grad_() for p in params]
        xr = x.detach().requires_grad_()
        return lambda: torch.autograd.grad(fn(xr, *leaves), (xr, *leaves), do)

    alpha, beta = (torch.tensor(c, device="cuda")
                   for c in norm_coefficients("vit"))
    return {
        "fused_block_attention": lambda: attn(x, *bf[0]),
        "fused_block_mlp": lambda: mlp(x, *bf[1]),
        "normalize_images": lambda: torch.addcmul(
            beta, images.to(torch.float32), alpha),
        "fused_block_attention_bwd": grad(attn, bf[0]),
        "fused_block_mlp_bwd": grad(mlp, bf[1]),
    }


def kernel_phases() -> dict:
    """Phases 3 and 4: each kernel against its plain version, then timed
    beside its plain version and a library call, with its bound."""
    from artgraph_tpu_torch import ops
    from artgraph_tpu_torch.ops import attention, mlp

    rng = np.random.default_rng(SEED)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    def block_params(out1, in2):
        return (dev(1.0 + 0.1 * rng.normal(size=C)),
                dev(0.1 * rng.normal(size=C)),
                dev(rng.normal(size=(out1, C)) / np.sqrt(C)),
                dev(0.02 * rng.normal(size=out1)),
                dev(rng.normal(size=(C, in2)) / np.sqrt(in2)),
                dev(0.02 * rng.normal(size=C)))

    x = dev(rng.normal(size=(B, N, C)), torch.bfloat16)
    attn_p, mlp_p = block_params(3 * C, C), block_params(HIDDEN, HIDDEN)
    images = torch.from_numpy(
        rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)).cuda()
    do = dev(rng.normal(size=(B, N, C)), torch.bfloat16)
    csrc = "artgraph_tpu_torch/ops/csrc/"
    cases = {
        "fused_block_attention": (
            lambda: ops.fused_block_attention(x, *attn_p, H),
            lambda: ops.block_attention_plain(x, *attn_p, H),
            csrc + "block_attention.cu", "artgraph_tpu/ops/attention.py:500"),
        "fused_block_mlp": (
            lambda: ops.fused_block_mlp(x, *mlp_p),
            lambda: ops.block_mlp_plain(x, *mlp_p),
            csrc + "block_gemm.cu", "artgraph_tpu/ops/mlp.py:167"),
        "normalize_images": (
            lambda: ops.normalize_images(images, "vit"),
            lambda: ops.normalize_images_plain(images, "vit"),
            csrc + "normalize.cu", "artgraph_tpu/ops/preprocess.py:79"),
        "fused_block_attention_bwd": (
            lambda: attention.block_attention_bwd_cuda(x, *attn_p, do, H,
                                                       1e-6),
            lambda: ops.block_attention_bwd_plain(x, *attn_p[:5], do, H),
            csrc + "block_attention_bwd.cu",
            "artgraph_tpu/ops/attention.py:529"),
        "fused_block_mlp_bwd": (
            lambda: mlp.block_mlp_bwd_cuda(x, *mlp_p, do, 1e-6),
            lambda: ops.block_mlp_bwd_plain(x, *mlp_p[:5], do),
            csrc + "block_gemm.cu", "artgraph_tpu/ops/mlp.py:197"),
    }
    results = {}
    for name, (kernel, plain, source, replaces) in cases.items():
        if name == "normalize_images":
            max_abs = 0.0
            for stats in ("resnet", "vit"):
                ours = ops.normalize_images(images, stats)
                torch.cuda.synchronize()
                ref = ops.normalize_images_plain(images, stats)
                if not torch.equal(ours, ref):
                    raise AssertionError(
                        f"normalize_images ({stats}) is not bit-exact: max "
                        f"abs error {(ours - ref).abs().max().item()}")
            print(f"check: normalize_images [{B},224,224,3] uint8 bit-exact "
                  f"vs plain for resnet and vit stats", flush=True)
        else:
            ours, again = kernel(), kernel()
            torch.cuda.synchronize()
            ref = plain()
            torch.cuda.synchronize()
            max_abs = (_check_grads(name, ours, ref) if name.endswith("_bwd")
                       else _check_output(name, ours, ref))
            if not all(torch.equal(a, g) for a, g in
                       zip(_as_tuple(ours), _as_tuple(again))):
                raise AssertionError(f"{name} differs from call to call")
            print(f"check: {name} bit-identical on repeat", flush=True)
        results[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": max_abs}
    library = _library_calls(x, do, attn_p, mlp_p, images)
    bounds = _bounds()
    for name, (kernel, plain, _, _) in cases.items():
        ms, plain_ms = _time_ms(kernel), _time_ms(plain)
        library_ms = _time_ms(library[name])
        bound_ms, bound_by = bounds[name]
        results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
        print(f"time: {name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) (median of 10 CUDA-event timings of 10 calls)",
              flush=True)
    return results


def _counters():
    from artgraph_tpu_torch.ops import attention, mlp, preprocess

    return {"fused_block_attention": (attention, "LAUNCHES"),
            "fused_block_mlp": (mlp, "LAUNCHES"),
            "normalize_images": (preprocess, "LAUNCHES"),
            "fused_block_attention_bwd": (attention, "LAUNCHES_BWD"),
            "fused_block_mlp_bwd": (mlp, "LAUNCHES_BWD")}


def _csr_counters():
    from artgraph_tpu_torch.ops import csr_segment

    return {"csr_segment_sum": (csr_segment, "LAUNCHES_SUM"),
            "csr_weighted_segment_sum": (csr_segment, "LAUNCHES_WEIGHTED"),
            "csr_attention_aggregate": (csr_segment, "LAUNCHES_SOFTMAX"),
            "csr_scalar_segment_sum": (csr_segment, "LAUNCHES_SCALAR")}


def _conv_bn_counters():
    from artgraph_tpu_torch.ops import conv_bn

    return {"conv1x1_bn_stats": (conv_bn, "LAUNCHES"),
            "conv1x1_bn_stats_bwd": (conv_bn, "LAUNCHES_BWD")}


def _mha_counters():
    from artgraph_tpu_torch.ops import attention

    return {"fused_attention": (attention, "LAUNCHES_ATTENTION"),
            "fused_attention_bwd": (attention, "LAUNCHES_ATTENTION_BWD"),
            "fused_qkv_attention": (attention, "LAUNCHES_QKV"),
            "fused_qkv_attention_bwd": (attention, "LAUNCHES_QKV_BWD")}


def _zero_counts() -> None:
    for mod, attr in (*_counters().values(), *_csr_counters().values(),
                      *_conv_bn_counters().values(),
                      *_mha_counters().values()):
        setattr(mod, attr, 0)


def _read_counts(counters=_counters) -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


def _csr_err(ours: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, worst error / (CSR_ATOL + CSR_RTOL |ref|)) of an f32
    output against an f64 reference; equal values, infinities included (the
    m of an empty segment), count as no error, a NaN as a failure."""
    a, r = ours.double(), ref.double()
    same = a == r
    err = torch.where(same, 0.0, (a - r).abs())
    ratio = torch.where(same, 0.0, err / (CSR_ATOL + CSR_RTOL * r.abs()))
    return err.max().item(), ratio.max().item()


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def csr_kernel_phases() -> dict:
    """Phases 3 and 4 for the four CSR segment kernels of the GNN stage, at
    the benchmark graph's shapes: E = 1M edges into the 32 `style` hubs
    (artwork -> style, "hub") and into 100K artworks (its reverse, "rev"),
    rows of F = 128 (the hidden convs) and 32 (the output conv). Each output
    against the plain twin in f64 on the same f32 inputs (the f32 twin sums
    the hubs' 31K edges with float atomics in a varying order, so its own
    error is printed beside), bit-identical from call to call; the softmax
    also with one logit +200. A kernel's row in the kernels line sums its
    cases' times and bounds."""
    from artgraph_tpu_torch.ops import csr_segment as T

    rng = np.random.default_rng(SEED + 30)
    E = GNN_EDGES
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    graphs = {}
    for label, S in (("hub", 32), ("rev", GNN_ARTWORKS)):
        ei = np.stack([rng.integers(0, GNN_ARTWORKS, E),
                       rng.integers(0, S, E)])
        csr = T.build_csr(ei, S, "cuda")[1]
        graphs[label] = (csr, torch.diff(csr.row_ptr).long())
    rows = {F: dev(rng.normal(size=(E, F))) for F in (128, 32)}
    w, logits = dev(rng.random(E)), dev(rng.normal(size=E))
    hot = logits.clone()
    hot[E // 2] += 200.0

    def library(name, csr, lengths, data, v):
        """One PyTorch composition per kernel: the yardstick."""
        def seg(t, how="sum"):
            return torch.segment_reduce(t, how, lengths=lengths, axis=0,
                                        unsafe=True)

        def softmax():
            m = seg(v, "max")
            e = torch.exp(v - m[csr.dst_sorted])
            num = data.new_zeros((csr.num_segments, data.shape[1]))
            return (num.index_add_(0, csr.dst_sorted, e[:, None] * data), m,
                    e.new_zeros(csr.num_segments).index_add_(
                        0, csr.dst_sorted, e))
        return {"csr_segment_sum": lambda: seg(data),
                "csr_weighted_segment_sum": lambda: (seg(v[:, None] * data),
                                                     seg(v)),
                "csr_attention_aggregate": softmax,
                "csr_scalar_segment_sum": lambda: seg(v)}[name]

    # name: kernel, plain twin, inputs of width F, (bytes, flops)(S, F),
    # Pallas call replaced
    specs = {
        "csr_segment_sum": (
            T.segment_sum_cuda, T.segment_sum_plain, lambda F: (rows[F],),
            lambda S, F: (4 * (E * F + S + 1 + S * F), E * F),
            "artgraph_tpu/ops/csr_segment.py:323"),
        "csr_weighted_segment_sum": (
            T.weighted_segment_sum_cuda, T.weighted_segment_sum_plain,
            lambda F: (rows[F], w),
            lambda S, F: (4 * (E * F + E + S + 1 + S * F + S), 2 * E * F + E),
            "artgraph_tpu/ops/csr_segment.py:355"),
        "csr_attention_aggregate": (
            T.softmax_aggregate_cuda, T.softmax_aggregate_plain,
            lambda F: (rows[F], logits),
            lambda S, F: (4 * (E * F + E + S + 1 + S * F + 2 * S),
                          2 * E * F + 4 * E),
            "artgraph_tpu/ops/csr_segment.py:452"),
        "csr_scalar_segment_sum": (
            T.scalar_segment_sum_cuda, T.scalar_segment_sum_plain,
            lambda F: (w,), lambda S, F: (4 * (E + S + 1 + S), E),
            "artgraph_tpu/ops/csr_segment.py:504"),
    }
    results = {}
    for name, (kernel, plain, inputs, cost, replaces) in specs.items():
        row = {"name": name, "route": "cuda",
               "source": "artgraph_tpu_torch/ops/csrc/csr_segment.cu",
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "bytes", "library_ms": 0.0}
        widths = (1,) if name == "csr_scalar_segment_sum" else (128, 32)
        for label, (csr, lengths) in graphs.items():
            for F in widths:
                args = inputs(F)
                variants = [("", args)]
                if name == "csr_attention_aggregate":
                    variants.append((", one logit +200", (args[0], hot)))
                for note, a in variants:
                    ours, again = kernel(*a, csr), kernel(*a, csr)
                    torch.cuda.synchronize()
                    ours, again = _as_tuple(ours), _as_tuple(again)
                    ref = _as_tuple(plain(*[t.double() for t in a], csr))
                    ref32 = _as_tuple(plain(*a, csr))
                    if not all(torch.equal(x, y) for x, y in zip(ours, again)):
                        raise AssertionError(f"{name} ({label}, F={F}{note}) "
                                             f"differs from call to call")
                    errs = [_csr_err(x, r) for x, r in zip(ours, ref)]
                    max_abs = max(e[0] for e in errs)
                    ratio = max(e[1] for e in errs)
                    plain_ratio = max(_csr_err(x, r)[1]
                                      for x, r in zip(ref32, ref))
                    shape = [E] + ([F] if name != "csr_scalar_segment_sum"
                                   else [])
                    print(f"check: {name} {label} S={csr.num_segments} "
                          f"{shape} f32{note} vs plain in f64: max abs "
                          f"{max_abs:.4g}, worst err/(atol+rtol|ref|) "
                          f"{ratio:.4g} (the f32 plain twin's own: "
                          f"{plain_ratio:.4g}); bit-identical on repeat",
                          flush=True)
                    if not ratio <= 1.0:
                        raise AssertionError(
                            f"{name} ({label}, F={F}{note}) disagrees with "
                            f"its plain twin beyond rtol={CSR_RTOL}, "
                            f"atol={CSR_ATOL}")
                    row["max_abs_err"] = max(row["max_abs_err"], max_abs)
                ms = _time_ms(lambda: kernel(*args, csr))
                plain_ms = _time_ms(lambda: plain(*args, csr))
                library_ms = _time_ms(library(name, csr, lengths, args[0],
                                              args[-1]))
                nbytes, flops = cost(csr.num_segments, F)
                bound_ms, bound_by = _bound(flops, nbytes, PEAK_F32)
                print(f"time: {name} {label} S={csr.num_segments} F={F} "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                      f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by}) (median of 10 CUDA-event timings of 10 "
                      f"calls)", flush=True)
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                row["library_ms"] += library_ms
                row["bound_ms"] += bound_ms
                row["bound_by"] = bound_by
        results[name] = row
    del rows, graphs
    torch.cuda.empty_cache()
    return results


def _unit_inputs(M: int, K: int, N: int, rng) -> tuple:
    """x [M, K], a, b [K] bf16 (a BatchNorm's apply coefficients), w [N, K]
    f32, and the cotangents dy [M, N] bf16, ds1, ds2 [N] f32, on the card.
    dy is a unit normal, so dx is of order one and the absolute part of its
    tolerance is small beside it (a dropped factor a or a wrong ReLU mask
    fails); ds1 and ds2 are scaled with it so that their terms in dyt stay
    visible."""
    dev = lambda v, dt=torch.float32: torch.from_numpy(
        np.asarray(v, np.float32)).to("cuda", dt)
    return (dev(rng.normal(size=(M, K)), torch.bfloat16),
            dev(1.0 + 0.2 * rng.normal(size=K), torch.bfloat16),
            dev(0.1 * rng.normal(size=K), torch.bfloat16),
            dev(rng.normal(size=(N, K)) / np.sqrt(K)),
            dev(rng.normal(size=(M, N)), torch.bfloat16),
            dev(1e-3 * np.sqrt(M) * rng.normal(size=N)),
            dev(1e-4 * np.sqrt(M) * rng.normal(size=N)))


UNIT_OUTPUTS = ("y", "s1", "s2", "dx", "da", "db", "dw")


def _unit_error(name: str, ours: torch.Tensor, ref: torch.Tensor,
                prologue: bool, atol: float) -> tuple[float, str, float,
                                                      float]:
    """One output of the fused unit against its plain twin's: (max abs
    error, what is held, its value, its limit). y and dx (bf16): the worst
    err / (atol + KERNEL_TOL |ref|), at most 1; da and db without the
    prologue: their max abs, exactly 0; the f32 rest: relative L2, at most
    GRAD_REL_L2."""
    if ours.dtype != ref.dtype or ours.shape != ref.shape:
        raise AssertionError(f"conv1x1_bn_stats {name}: {ours.dtype} "
                             f"{tuple(ours.shape)}, plain {ref.dtype} "
                             f"{tuple(ref.shape)}")
    o, r = ours.double(), ref.double()
    if not torch.isfinite(o).all():
        raise AssertionError(f"conv1x1_bn_stats {name}: not finite")
    max_abs = (o - r).abs().max().item()
    if name in ("y", "dx"):
        ratio = ((o - r).abs() / (atol + KERNEL_TOL * r.abs())).max().item()
        return max_abs, "worst err/(atol+rtol|ref|)", ratio, 1.0
    if not prologue and name in ("da", "db"):
        zero = o.abs().max().item()
        return zero, "max abs (zero without the prologue)", zero, 0.0
    return max_abs, "rel L2", ((o - r).norm() / r.norm()).item(), GRAD_REL_L2


def conv_bn_kernel_phases() -> dict:
    """Phases 3 and 4 for the fused 1x1-conv + BN-statistics unit at
    CONV_BN_SHAPES: both kernels against the plain twins on the card,
    bit-identical from call to call, then timed beside the plain twins and a
    library yardstick (the prologue as torch elementwise ops, torch.matmul
    and the two column sums; the backward's two matmuls from dyt and z made
    outside the timed call). A row of the kernels line sums its three
    shapes' times and bounds."""
    from artgraph_tpu_torch.ops import conv_bn as U

    rng = np.random.default_rng(SEED + 60)
    rows = {name: {"name": name, "route": "cuda",
                   "source": "artgraph_tpu_torch/ops/csrc/conv_bn.cu",
                   "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
                   "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bound_by": "bytes", "library_ms": 0.0}
            for name, replaces in (
                ("conv1x1_bn_stats", "artgraph_tpu/ops/conv_bn.py:161"),
                ("conv1x1_bn_stats_bwd", "artgraph_tpu/ops/conv_bn.py:188"))}
    for M, K, N, pro in CONV_BN_SHAPES:
        x, a, b, w, dy, ds1, ds2 = _unit_inputs(M, K, N, rng)
        label = f"M={M} K={K} N={N} prologue={pro}"
        fwd = [U.conv1x1_bn_stats_cuda(x, a, b, w, pro) for _ in range(2)]
        y = fwd[0][0]
        bwd = [U.conv1x1_bn_stats_bwd_cuda(x, a, b, w, y, dy, ds1, ds2, pro)
               for _ in range(2)]
        torch.cuda.synchronize()
        ref = (*U.conv1x1_bn_stats_plain(x, a, b, w, pro),
               *U.conv1x1_bn_stats_bwd_plain(x, a, b, w, y, dy, ds1, ds2,
                                             pro))
        torch.cuda.synchronize()
        for i, (name, ours, again, r) in enumerate(zip(
                UNIT_OUTPUTS, (*fwd[0], *bwd[0]), (*fwd[1], *bwd[1]), ref)):
            row = rows["conv1x1_bn_stats" if i < 3 else
                       "conv1x1_bn_stats_bwd"]
            if not torch.equal(ours, again):
                raise AssertionError(f"conv1x1_bn_stats {name} ({label}) "
                                     f"differs from call to call")
            max_abs, held, value, limit = _unit_error(name, ours, r, pro,
                                                      KERNEL_TOL)
            print(f"check: conv1x1_bn_stats {name} ({label}) "
                  f"{str(r.dtype)[6:]} vs plain: max abs {max_abs:.4g}, "
                  f"mean|plain| {r.double().abs().mean().item():.4g}, {held} "
                  f"{value:.4g} (limit {limit:g}); bit-identical on repeat",
                  flush=True)
            if not value <= limit:
                raise AssertionError(f"conv1x1_bn_stats {name} ({label}) "
                                     f"disagrees with its plain version: "
                                     f"{held} {value} > {limit}")
            row["max_abs_err"] = max(row["max_abs_err"], max_abs)

        wb = w.to(torch.bfloat16)
        z = (torch.relu(x * a + b) if pro else x).contiguous()
        dyt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(torch.bfloat16)

        def lib_fwd():
            zz = torch.relu(x * a + b) if pro else x
            yy = torch.matmul(zz, wb.t()).float()
            return yy.sum(0), yy.square().sum(0)

        cases = {
            "conv1x1_bn_stats": (
                lambda: U.conv1x1_bn_stats_cuda(x, a, b, w, pro),
                lambda: U.conv1x1_bn_stats_plain(x, a, b, w, pro), lib_fwd,
                2 * M * K * N,
                2 * (M * K + N * K + 2 * K + M * N) + 4 * 2 * N),
            "conv1x1_bn_stats_bwd": (
                lambda: U.conv1x1_bn_stats_bwd_cuda(x, a, b, w, y, dy, ds1,
                                                    ds2, pro),
                lambda: U.conv1x1_bn_stats_bwd_plain(x, a, b, w, y, dy, ds1,
                                                     ds2, pro),
                lambda: (torch.matmul(dyt, wb), torch.matmul(dyt.t(), z)),
                4 * M * K * N,
                2 * (2 * M * K + N * K + 2 * K + 2 * M * N) + 4 * 2 * N
                + 4 * (N * K + 2 * K)),
        }
        for name, (kernel, plain, library, flops, nbytes) in cases.items():
            ms, plain_ms = _time_ms(kernel), _time_ms(plain)
            library_ms = _time_ms(library)
            bound_ms, bound_by = _bound(flops, nbytes)
            print(f"time: {name} {label} kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s (median of 10 CUDA-event "
                  f"timings of 10 calls)", flush=True)
            row = rows[name]
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["library_ms"] += library_ms
            row["bound_ms"] += bound_ms
            if bound_ms > row.get("_largest", 0.0):   # the row's bound_by:
                row["_largest"] = bound_ms             # its largest shape's
                row["bound_by"] = bound_by
        del x, a, b, w, dy, fwd, bwd, ref, z, dyt
        torch.cuda.empty_cache()
    for row in rows.values():
        del row["_largest"]
    return rows


def _long_sequence_check(rng, dev, n: int = LONG_N, heads: int = 2) -> None:
    """fused_attention forward and backward at N = LONG_N on a few heads,
    against the twins at rtol = atol = KERNEL_TOL and bit-identical on
    repeat: a sequence whose [64, N] score tile would not fit in shared
    memory, which the tiled cores take in the same 27-37 KB."""
    from artgraph_tpu_torch.ops import attention as A

    qkv = dev(rng.normal(size=(2, n, 3, heads, D)), torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = dev(rng.normal(size=(2, n, heads, D)), torch.bfloat16)
    out = A.fused_attention_cuda(q, k, v)
    ours = (out, *A.fused_attention_bwd_cuda(q, k, v, out, do))
    again = (A.fused_attention_cuda(q, k, v),
             *A.fused_attention_bwd_cuda(q, k, v, out, do))
    torch.cuda.synchronize()
    ref = (A.fused_attention_plain(q, k, v),
           *A.fused_attention_bwd_plain(q, k, v, out, do))
    for name, a, r, g in zip(("out", "dq", "dk", "dv"), ours, ref, again):
        _check_output(f"fused_attention N={n} {name}", a, r)
        if not torch.equal(a, g):
            raise AssertionError(f"fused_attention N={n} {name} differs from "
                                 f"call to call")
    print(f"check: fused_attention N={n} forward and backward bit-identical "
          f"on repeat", flush=True)


def attention_kernel_phases() -> dict:
    """Phases 3 and 4 for the kernels of fused_attention and
    fused_qkv_attention (forward and backward) at the ViT-B/16 shapes: q, k,
    v strided views of one [B, N, 3, H, D] bf16 tensor, x [B, N, C], a
    seeded output gradient. Each against its plain twin on the card (bf16
    outputs, dq/dk/dv and dx at rtol = atol = KERNEL_TOL; the f32 dw, db as
    in phase 3), bit-identical on repeat; timed beside the twin and a
    library yardstick: F.scaled_dot_product_attention on [B, H, N, D] views
    (after F.linear for the qkv op), and autograd of the same (forward and
    backward, as the block rows' yardsticks) for the backwards."""
    import torch.nn.functional as F

    from artgraph_tpu_torch.ops import attention as A

    rng = np.random.default_rng(SEED + 80)
    dev = lambda a, dt=torch.float32: torch.from_numpy(
        np.asarray(a, np.float32)).to("cuda", dt)
    qkv = dev(rng.normal(size=(B, N, 3, H, D)), torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = dev(rng.normal(size=(B, N, H, D)), torch.bfloat16)
    x = dev(rng.normal(size=(B, N, C)), torch.bfloat16)
    w = dev(rng.normal(size=(3 * C, C)) / np.sqrt(C))
    b = dev(0.02 * rng.normal(size=3 * C))
    dout = do.view(B, N, C)
    if q.stride(1) != 3 * C or q.data_ptr() != qkv.data_ptr():
        raise AssertionError("q is not a strided view of the qkv tensor")
    out = A.fused_attention_cuda(q, k, v)
    xout = A.fused_qkv_attention_cuda(x, w, b, H)
    cases = {
        "fused_attention": (
            lambda: A.fused_attention_cuda(q, k, v),
            lambda: A.fused_attention_plain(q, k, v),
            "block_attention.cu", "artgraph_tpu/ops/attention.py:41"),
        "fused_attention_bwd": (
            lambda: A.fused_attention_bwd_cuda(q, k, v, out, do),
            lambda: A.fused_attention_bwd_plain(q, k, v, out, do),
            "block_attention_bwd.cu", "artgraph_tpu/ops/attention.py:61"),
        "fused_qkv_attention": (
            lambda: A.fused_qkv_attention_cuda(x, w, b, H),
            lambda: A.fused_qkv_attention_plain(x, w, b, H),
            "block_attention.cu", "artgraph_tpu/ops/attention.py:183"),
        "fused_qkv_attention_bwd": (
            lambda: A.fused_qkv_attention_bwd_cuda(x, w, b, xout, dout, H),
            lambda: A.fused_qkv_attention_bwd_plain(x, w, b, xout, dout, H),
            "block_attention_bwd.cu", "artgraph_tpu/ops/attention.py:209"),
    }
    results = {}
    for name, (kernel, plain, source, replaces) in cases.items():
        ours, again = _as_tuple(kernel()), _as_tuple(kernel())
        torch.cuda.synchronize()
        ref = _as_tuple(plain())
        torch.cuda.synchronize()
        if not all(torch.equal(a, g) for a, g in zip(ours, again)):
            raise AssertionError(f"{name} differs from call to call")
        if name == "fused_qkv_attention_bwd":
            max_abs = _check_output(f"{name} dx", ours[0], ref[0])
            max_abs = max(max_abs, _check_param_grad(name, "dw", ours[1],
                                                     ref[1]))
            max_abs = max(max_abs, _check_param_grad(name, "db", ours[2],
                                                     ref[2], qkv_bias=True))
        else:
            grads = ("dq", "dk", "dv") if name.endswith("_bwd") else ("",)
            max_abs = max(_check_output(f"{name} {g}".strip(), a, r)
                          for g, a, r in zip(grads, ours, ref))
        print(f"check: {name} bit-identical on repeat", flush=True)
        results[name] = {"name": name, "route": "cuda",
                         "source": "artgraph_tpu_torch/ops/csrc/" + source,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": max_abs}
    _long_sequence_check(rng, dev)

    heads = lambda t: t.transpose(1, 2)                  # [B, H, N, D] view
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)

    def qkv_lib(x, wb, bb):
        t = F.linear(x, wb, bb).view(B, N, 3, H, D)
        o = F.scaled_dot_product_attention(*(heads(u) for u in t.unbind(2)))
        return heads(o).reshape(B, N, C)

    def grad(fn, leaves, cotangent):
        leaves = [t.detach().requires_grad_() for t in leaves]
        return lambda: torch.autograd.grad(fn(*leaves), leaves, cotangent)

    library = {
        "fused_attention": lambda: F.scaled_dot_product_attention(
            heads(q), heads(k), heads(v)),
        "fused_attention_bwd": grad(
            lambda *t: F.scaled_dot_product_attention(*t),
            [heads(q), heads(k), heads(v)], heads(do)),
        "fused_qkv_attention": lambda: qkv_lib(x, wb, bb),
        "fused_qkv_attention_bwd": grad(qkv_lib, [x, wb, bb], dout),
    }
    act = B * N * C * 2                          # one bf16 [B, N, C] tensor
    core = 2 * B * H * N * N * D                 # one [N, N] x [N, D] product
    gemm = 2 * B * N * C * 3 * C                 # the qkv product, or dx, dW
    params = (3 * C * C + 3 * C) * 4
    bounds = {
        "fused_attention": _bound(2 * core, 4 * act),
        # S recomputed, dV, dP, dQ, dK; q, k, v, o, do in, dq, dk, dv out
        "fused_attention_bwd": _bound(5 * core, 8 * act),
        "fused_qkv_attention": _bound(gemm + 2 * core, 2 * act + params),
        # qkv recomputed, the core backward, dx, dW
        "fused_qkv_attention_bwd": _bound(3 * gemm + 5 * core,
                                          4 * act + 2 * params),
    }
    for name, (kernel, plain, _, _) in cases.items():
        ms, plain_ms = _time_ms(kernel), _time_ms(plain)
        library_ms = _time_ms(library[name])
        bound_ms, bound_by = bounds[name]
        results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
        print(f"time: {name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) (median of 10 CUDA-event timings of 10 calls)",
              flush=True)
    del qkv, q, k, v, do, x, w, b, out, xout, library
    torch.cuda.empty_cache()
    return results


def serve_phase() -> dict:
    """Phase 5: both ViT-B/16 models through cli.predict.infer on cuda."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli.predict import infer
    from artgraph_tpu_torch.models import (NewMultiModalMultiTaskViT,
                                           ViTSingleTask, init_random_)

    expect = dict.fromkeys(_counters(), 0)
    expect.update(fused_block_attention=12 * BATCHES,
                  fused_block_mlp=12 * BATCHES, normalize_images=BATCHES)
    launches = dict.fromkeys(expect, 0)
    specs = [
        ("ViTSingleTask", lambda: ViTSingleTask(32), 0),
        ("NewMultiModalMultiTaskViT",
         lambda: NewMultiModalMultiTaskViT(config.EMB_SIZE,
                                           config.NUM_CLASSES), 2),
    ]
    rng = np.random.default_rng(SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, ctor, n_emb) in enumerate(specs):
            path = os.path.join(tmp, f"{name}.pt")
            src = init_random_(ctor(), torch.Generator().manual_seed(SEED + i))
            torch.save(src.state_dict(), path)
            del src
            model = load_reference_checkpoint(name, path, "cuda")
            batches = [
                (torch.from_numpy(rng.integers(0, 256, (B, 224, 224, 3),
                                               dtype=np.uint8)).cuda(),
                 *[torch.from_numpy(rng.normal(size=(B, config.EMB_SIZE))
                                    .astype(np.float32)).cuda()
                   for _ in range(n_emb)])
                for _ in range(BATCHES)]
            infer(model, *batches[0])        # warm-up, before the count
            torch.cuda.synchronize()

            _zero_counts()
            t0 = time.perf_counter()
            outs = [infer(model, *batch) for batch in batches]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _read_counts()
            if counts != expect:
                raise AssertionError(f"{name}: launch counts {counts}, "
                                     f"expected {expect}")
            for k, n in counts.items():
                launches[k] += n

            outs = [o if isinstance(o, list) else [o] for o in outs]
            for logits in (t for o in outs for t in o):
                if logits.dtype != torch.float32 or logits.shape[0] != B \
                        or not torch.isfinite(logits).all():
                    raise AssertionError(
                        f"{name}: bad logits {logits.dtype} "
                        f"{tuple(logits.shape)}")
            cpu = load_reference_checkpoint(name, path, "cpu",
                                            dtype=torch.float32)
            ref = infer(cpu, *[t[:2].cpu() for t in batches[0]])
            ref = ref if isinstance(ref, list) else [ref]
            rel = max((o[:2].cpu() - r).norm().item() / r.norm().item()
                      for o, r in zip(outs[0], ref))
            print(f"serve: {name} bf16 on cuda, {BATCHES} batches of {B}: "
                  f"{BATCHES * B / seconds:.1f} img/s, launches {counts}, "
                  f"rel L2 vs f32 CPU plain on 2 images {rel:.4g}", flush=True)
            if not rel <= E2E_REL_L2:
                raise AssertionError(f"{name}: rel L2 {rel} > {E2E_REL_L2}")
            del model, cpu
            torch.cuda.empty_cache()
    return launches


# chrome-trace categories of device work; "gpu_user_annotation" spans (such
# as the optimizer's Optimizer.step#Adam.step) cover kernels counted on
# their own and are left out
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _profile_steps(step, steps: int, step_ms: float,
                   label: str = "train") -> None:
    """Device time by kernel over `steps` profiled steps, and the device idle
    share against the unprofiled step time. Busy time sums the device's
    kernels, memcpys and memsets, read by category from the profiler's
    chrome trace; the user-annotation spans on the device timeline are left
    out and their time printed beside."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    work, spans = {}, {}
    for ev in events:
        cat = ev.get("cat")
        if cat in DEVICE_WORK or cat == "gpu_user_annotation":
            total = (work if cat in DEVICE_WORK else spans).setdefault(
                ev["name"], [0.0, 0])
            total[0] += ev.get("dur", 0.0) / steps / 1e3
            total[1] += 1
    kernels = sorted(((ms, n // steps, name)
                      for name, (ms, n) in work.items()), reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    if busy <= 0:
        print(f"{label} profile: the profiler saw no device time; idle share "
              "not measured", flush=True)
        return
    dropped = ", ".join(f"{name} {ms:.3f} ms"
                        for name, (ms, _) in spans.items())
    print(f"{label} profile: device busy {busy:.3f} ms per step (kernels, "
          f"memcpys, memsets) against {step_ms:.3f} ms per unprofiled step: "
          f"idle share {max(0.0, 1 - busy / step_ms):.4f}; user-annotation "
          f"spans left out: {dropped or 'none'}", flush=True)
    for ms, calls, name in kernels[:14]:
        print(f"{label} profile:   {ms:8.3f} ms/step {100 * ms / busy:5.1f}% "
              f"{calls:4d} calls  {name[:110]}", flush=True)


def train_phase() -> dict:
    """Phase 6: ViT-B/16 training steps through the Trainer on cuda."""
    from artgraph_tpu_torch.cli._common import single_task_loss
    from artgraph_tpu_torch.models import ViTSingleTask, init_random_
    from artgraph_tpu_torch.train import Trainer, adam

    model = init_random_(ViTSingleTask(32, dropout=0.4),
                         torch.Generator().manual_seed(SEED + 10))
    trainer = Trainer(model, adam(3e-4), single_task_loss(None),
                      transform_type="vit", device="cuda")
    rng = np.random.default_rng(SEED + 2)
    batch = (rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8),
             rng.integers(0, 32, B).astype(np.int32),
             np.ones(B, np.float32))
    trainer.model.train()

    def step():
        return trainer.train_step(trainer.to_device(batch))[0]

    losses = [step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses += [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    expect = {k: 12 * TRAIN_STEPS for k in counts}
    expect["normalize_images"] = TRAIN_STEPS
    if counts != expect:
        raise AssertionError(f"train: launch counts {counts}, expected "
                             f"{expect}")
    losses = torch.stack(losses).tolist()
    print(f"train: ViTSingleTask(32) ViT-B/16 bf16, adam(3e-4), dropout 0.4, "
          f"batch {B} on cuda: {TRAIN_STEPS} steps in {seconds:.3f} s, "
          f"{TRAIN_STEPS * B / seconds:.1f} img/s, "
          f"{1e3 * seconds / TRAIN_STEPS:.2f} ms/step; launches {counts}; "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses not finite and falling: "
                             f"{losses}")
    _profile_steps(step, PROFILED_STEPS, 1e3 * seconds / TRAIN_STEPS)
    del trainer, model
    torch.cuda.empty_cache()
    return counts


def grad_phase(unfused: bool = False) -> None:
    """Phase 7: one step's trunk gradients, bf16 kernels vs f32 CPU plain;
    with `unfused`, of the ViT(fuse_qkv=False) trunk (phase 17)."""
    from artgraph_tpu_torch.models import ViTSingleTask, init_random_
    from artgraph_tpu_torch.ops import normalize_images
    from artgraph_tpu_torch.train import cross_entropy

    rng = np.random.default_rng(SEED + 3)
    images = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 32, 2))
    src = init_random_(ViTSingleTask(32), torch.Generator()
                       .manual_seed(SEED + 20))
    grads = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = ViTSingleTask(32, dropout=0.0, dtype=dtype)
        model.load_state_dict(src.state_dict())
        if unfused:
            model = _unfused_vit(model)
        model = model.to(device).train()
        logits = model(normalize_images(images.to(device), "vit"))
        cross_entropy(logits, labels.to(device)).backward()
        trunk = {n: p.grad for n, p in model.named_parameters()
                 if n.startswith("vit.") and not n.startswith("vit.head.")}
        if any(g is None or not torch.isfinite(g).all()
               for g in trunk.values()):
            raise AssertionError(f"grads: a trunk parameter on {device} has "
                                 f"no finite gradient")
        grads[device] = {n: g.to("cpu", torch.float64)
                         for n, g in trunk.items()}
    names = sorted(grads["cpu"])
    cat = lambda d, ns: torch.cat([d[n].flatten() for n in ns])
    groups = {"patch_embed+cls+pos": [n for n in names if "blocks." not in n
                                      and not n.startswith("vit.norm")],
              "blocks": [n for n in names if "blocks." in n],
              "final norm": [n for n in names if n.startswith("vit.norm")]}
    parts = ", ".join(
        f"{g} {((cat(grads['cuda'], ns) - cat(grads['cpu'], ns)).norm() / cat(grads['cpu'], ns).norm()).item():.4g}"
        for g, ns in groups.items())
    rel = ((cat(grads["cuda"], names) - cat(grads["cpu"], names)).norm()
           / cat(grads["cpu"], names).norm()).item()
    label = "vit unfused grads" if unfused else "grads"
    print(f"{label}: one step on 2 images, {len(names)} trunk tensors, bf16 "
          f"kernels on cuda vs f32 plain on the CPU: rel L2 {rel:.4g} "
          f"(bound {TRAIN_GRAD_REL_L2}); by group: {parts}", flush=True)
    if not rel <= TRAIN_GRAD_REL_L2:
        raise AssertionError(f"{label}: rel L2 {rel} > {TRAIN_GRAD_REL_L2}")


def cli_phase(checkpoints_dir: Path) -> None:
    """Phase 8: cli.train_baseline --architecture vit on cuda."""
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli import train_baseline

    spec = importlib.util.spec_from_file_location(
        "_make_synth", REPO / "tests" / "_make_synth.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        counts = synth.make_image_tree(root)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            acc = train_baseline.main([
                "--dataset_path", str(root / "dataset"),
                "--image_path", str(root / "images"), "--architecture", "vit",
                "--label", "style", "--epochs", "1", "--batch", "8",
                "--num_workers", "4", "--device", "cuda",
                "--results_dir", str(root / "results")])
        seconds = time.perf_counter() - t0
        text = out.getvalue()
        for line in text.splitlines():
            print(f"cli: {line}")
        for want in ("Train loss: ", "Validation loss: ",
                     f"Test accuracy: {acc}"):
            if want not in text:
                raise AssertionError(f"cli: no line with {want!r}")
        if not (root / "results" / "results.csv").exists():
            raise AssertionError("cli: no results.csv")
    path = checkpoints_dir / "style_vit_baseline_single-task_checkpoint.pt"
    model = load_reference_checkpoint("ViTSingleTask", str(path), "cuda")
    print(f"cli: train_baseline --architecture vit --device cuda, 1 epoch on "
          f"{counts} synthetic images in {seconds:.1f} s; checkpoint "
          f"{path.name} reloaded strict ({len(model.state_dict())} tensors); "
          f"test accuracy {acc}", flush=True)


def _bench_graph(artworks: int, edges_per_rel: int, artists: int, tags: int,
                 seed: int):
    """The JAX package's GNN benchmark graph (bench.py:221-246) as the
    port's HeteroGraph, from a numpy seed: artworks with 128-d features, 32
    styles, 18 genres, the artists and tags one-hot; 4 relations out of the
    artworks, each with its reverse, of `edges_per_rel` random edges; random
    style labels."""
    from artgraph_tpu_torch.data.artgraph import HeteroGraph, OneHot

    rng = np.random.default_rng(seed)
    num = {"artwork": artworks, "style": 32, "genre": 18, "artist": artists,
           "tag": tags}
    feats = {t: OneHot(n) for t, n in num.items() if t != "artwork"}
    feats["artwork"] = rng.normal(size=(artworks, 128)).astype(np.float32)
    edges = {}
    for h, r, t in (("artwork", "style_rel", "style"),
                    ("artwork", "genre_rel", "genre"),
                    ("artwork", "author_rel", "artist"),
                    ("artwork", "about_rel", "tag")):
        e = np.stack([rng.integers(0, num[h], edges_per_rel),
                      rng.integers(0, num[t], edges_per_rel)]).astype(np.int32)
        edges[(h, r, t)] = e
        edges[(t, f"rev_{r}", h)] = e[::-1].copy()
    labels = {"y_style": rng.integers(0, 32, artworks).astype(np.int32)}
    return HeteroGraph(node_features=feats, num_nodes=num, edges=edges,
                       labels=labels)


def _gnn_model(graph, dropout: float):
    """HeteroSGNN as train_gnn_embeddings builds it (GATConv, hidden 128,
    out 32, 2 layers, sum, BN), seeded weights, on the CPU."""
    from artgraph_tpu_torch.models.gnn import HeteroSGNN, feature_dims

    torch.manual_seed(SEED)
    return HeteroSGNN(graph.metadata, feature_dims(graph.node_features),
                      operator="GATConv", hidden_channels=128,
                      out_channels=32, n_layers=2, dropout=dropout)


def _graph_on(graph, device: str):
    """(x, edges, csr, y) on `device`: edges sorted by destination and the
    CSR metadata built once (with_csr)."""
    from artgraph_tpu_torch.data.artgraph import with_csr
    from artgraph_tpu_torch.models.gnn import graph_tensors

    g, csr = with_csr(graph, device)
    x, edges = graph_tensors(g, device)
    y = torch.from_numpy(g.labels["y_style"].astype(np.int64)).to(device)
    return x, edges, csr, y


def _gnn_loss(model, x, edges, csr, y, generator=None):
    from artgraph_tpu_torch.train import nll_loss

    emb, outs = model(x, edges, csr=csr, generator=generator)
    return nll_loss(outs[0]["artwork"], y), emb


def gnn_train_phase() -> dict:
    """Phase 9: HeteroSGNN GAT training steps on the benchmark graph on cuda
    (100K artworks, 8 relations of 1M edges)."""
    from artgraph_tpu_torch.train import adam

    t0 = time.perf_counter()
    graph = _bench_graph(GNN_ARTWORKS, GNN_EDGES, 5_000, 10_000, SEED)
    x, edges, csr, y = _graph_on(graph, "cuda")
    model = _gnn_model(graph, 0.4).cuda().train()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    opt = adam(0.01)(model.parameters())
    gen = torch.Generator("cuda").manual_seed(SEED)

    def step():
        loss, _ = _gnn_loss(model, x, edges, csr, y, gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(GNN_WARMUP)]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses += [step() for _ in range(GNN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, vit = _read_counts(_csr_counters), _read_counts()
    # the softmax kernel runs in every conv's forward; the sum and scalar
    # kernels in the backward of every conv on a path to the loss, which
    # reads the artwork log-probs only: all hidden convs, and the output
    # convs into the artworks (autograd never reaches the others)
    n_rel = len(graph.edges)
    into_artwork = sum(t == "artwork" for _, _, t in graph.edges)
    bwd = (2 * n_rel + into_artwork) * GNN_STEPS
    expect = {"csr_segment_sum": bwd, "csr_weighted_segment_sum": 0,
              "csr_attention_aggregate": 3 * n_rel * GNN_STEPS,
              "csr_scalar_segment_sum": bwd}
    if counts != expect or any(vit.values()):
        raise AssertionError(f"gnn train: launch counts {counts} and {vit}, "
                             f"expected {expect} and none of the ViT kernels")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()
    total_edges = sum(e.shape[1] for e in graph.edges.values())
    step_ms = 1e3 * seconds / GNN_STEPS
    print(f"gnn train: HeteroSGNN GATConv hidden 128, out 32, 2 layers, BN, "
          f"dropout 0.4, adam(0.01) on cuda; {GNN_ARTWORKS} artworks, "
          f"{n_rel} relations, {total_edges} edges (setup {setup_s:.1f} s): "
          f"{GNN_STEPS} steps in {seconds:.4f} s, {step_ms:.3f} ms/step, "
          f"{total_edges * GNN_STEPS / seconds:.4g} edges/s; peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated); launches {counts}; "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"gnn train: losses not finite and falling: "
                             f"{losses}")
    model.eval()

    def embed():
        with torch.no_grad():
            return model(x, edges, csr=csr)[0]["artwork"]

    emb = embed()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embed()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if emb.shape != (GNN_ARTWORKS, 128) or not torch.isfinite(emb).all():
        raise AssertionError(f"gnn eval: embeddings {tuple(emb.shape)} not "
                             f"finite or not [{GNN_ARTWORKS}, 128]")
    print(f"gnn eval: one eval forward (the embedding save) "
          f"{float(np.median(times)):.3f} ms (median of 3), embeddings "
          f"{list(emb.shape)} finite", flush=True)
    model.train()
    _profile_steps(step, PROFILED_STEPS, step_ms, label="gnn")
    del model, opt, x, edges, csr
    torch.cuda.empty_cache()
    return counts


def gnn_grad_phase() -> None:
    """Phase 10: one train-mode GNN step (dropout 0) on a reduced graph of
    the benchmark's schema, the kernels on cuda against the plain path in
    f32 on the CPU with the same weights."""
    import copy

    graph = _bench_graph(5_000, 20_000, 250, 500, SEED + 40)
    src = _gnn_model(graph, 0.0)
    got = {}
    for device in ("cuda", "cpu"):
        x, edges, csr, y = _graph_on(graph, device)
        model = copy.deepcopy(src).to(device).train()
        loss, emb = _gnn_loss(model, x, edges, csr, y)
        loss.backward()
        reached = [p.grad is not None for p in model.parameters()]
        grads = torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).flatten()
                           for p in model.parameters()])
        stats = torch.cat([b.flatten().double() for n, b in
                           model.named_buffers() if "running" in n])
        got[device] = (reached, loss.item(),
                       *[t.detach().cpu().double()
                         for t in (emb["artwork"], grads, stats)])
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    (r_gpu, l_gpu, *gpu), (r_cpu, l_cpu, *cpu) = got["cuda"], got["cpu"]
    rels = {"loss": abs(l_gpu - l_cpu) / abs(l_cpu),
            **{k: rel(a, b) for k, a, b in zip(
                ("artwork embeddings", "parameter gradient", "BN stats"),
                gpu, cpu)}}
    print(f"gnn grads: one step, {graph.num_nodes['artwork']} artworks, "
          f"{sum(e.shape[1] for e in graph.edges.values())} edges, kernels "
          f"on cuda vs plain f32 on the CPU: relative L2 "
          f"{ {k: float(f'{v:.4g}') for k, v in rels.items()} } (bound "
          f"{GNN_GRAD_REL_L2}); {sum(r_gpu)} of {len(r_gpu)} parameter "
          f"tensors reached on both", flush=True)
    if r_gpu != r_cpu or not all(v <= GNN_GRAD_REL_L2 for v in rels.values()):
        raise AssertionError(f"gnn grads: {rels} beyond {GNN_GRAD_REL_L2}, "
                             f"or other parameters reached")


def _write_kg(root: Path, seed: int) -> dict:
    """A small ArtGraph KG tree (the layout of tests/conftest.py's
    synthetic_graph): the 4 graph variants, each with 128-d artwork
    features, style/genre labels, num-node-dict and the 9 relations."""
    import pandas as pd

    from artgraph_tpu_torch.data.artgraph import EDGE_TYPES

    rng = np.random.default_rng(seed)
    counts = {"artwork": 200, "artist": 20, "gallery": 6, "style": 8,
              "genre": 6, "tag": 30, "media": 5, "field": 4, "movement": 4}
    for name in ("train", "train_train", "train_validation", "train_test"):
        raw = root / name / "raw"
        (raw / "node-feat" / "artwork").mkdir(parents=True)
        (raw / "node-label" / "artwork").mkdir(parents=True)
        pd.DataFrame(rng.normal(size=(counts["artwork"], 128)).astype(
            np.float32)).to_csv(raw / "node-feat" / "artwork" /
                                "node-feat.csv", header=False, index=False)
        for label in ("style", "genre"):
            pd.Series(rng.integers(0, counts[label], counts["artwork"])
                      .astype(np.float32)).to_csv(
                raw / "node-label" / "artwork" / f"node-label-{label}.csv",
                header=False, index=False)
        pd.DataFrame({k: [v] for k, v in counts.items()}).to_csv(
            raw / "num-node-dict.csv", index=False)
        for h, r, t in EDGE_TYPES:
            d = raw / "relations" / f"{h}___{r}___{t}"
            d.mkdir(parents=True)
            pd.DataFrame({"src": rng.integers(0, counts[h], 400),
                          "dst": rng.integers(0, counts[t], 400)}).to_csv(
                d / "edge.csv", header=False, index=False)
    return counts


def gnn_cli_phase() -> None:
    """Phase 11: cli.train_gnn_embeddings --device cuda --epochs 6 on a
    small KG tree; both embedding files reloaded."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli import train_gnn_embeddings
    from artgraph_tpu_torch.data.embeddings import load_embedding

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        counts = _write_kg(root / "kg", SEED + 50)
        saved = config.DATASET_DIR, config.EMBEDDINGS_DIR
        config.DATASET_DIR, config.EMBEDDINGS_DIR = (str(root / "kg"),
                                                     str(root / "emb"))
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                train_gnn_embeddings.main(["--device", "cuda", "--epochs",
                                           "6"])
        finally:
            config.DATASET_DIR, config.EMBEDDINGS_DIR = saved
        seconds = time.perf_counter() - t0
        text = out.getvalue()
        for line in text.splitlines():
            print(f"gnn cli: {line}")
        if text.count("style_val_loss") != 3 or "style_test_accuracy" \
                not in text or "Saved." not in text:
            raise AssertionError("gnn cli: missing metric lines")
        shapes = []
        for stem in ("test_gnn_artwork_style_embs", "test_gnn_style_embs"):
            emb = load_embedding(str(root / "emb" / f"{stem}.pt"))
            if emb.shape != (counts["artwork"], 128) \
                    or not np.isfinite(emb).all():
                raise AssertionError(f"gnn cli: {stem}.pt is {emb.shape} or "
                                     f"not finite")
            shapes.append(f"{stem}.pt {list(emb.shape)}")
    print(f"gnn cli: train_gnn_embeddings --device cuda --epochs 6 on a "
          f"{counts['artwork']}-artwork KG in {seconds:.1f} s; reloaded "
          f"{', '.join(shapes)}, finite", flush=True)


def _seeded_resnet_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and BatchNorm statistic of a ResNet model from a
    torch generator (n a standard normal draw): conv and Linear weights
    n / sqrt(fan_in), BN weights 1 + 0.1 n, biases and running means 0.1 n,
    running variances U(0.5, 1.5). For runs without published weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in (*model.named_parameters(), *model.named_buffers()):
            if name.endswith("num_batches_tracked"):
                continue
            n = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif t.dim() > 1:
                t.copy_(n / np.sqrt(t[0].numel()))
            elif name.endswith("weight"):
                t.copy_(1.0 + 0.1 * n)
            else:
                t.copy_(0.1 * n)
    return model


def _all_counts() -> dict:
    return {**_read_counts(), **_read_counts(_conv_bn_counters),
            **_read_counts(_mha_counters)}


def resnet_serve_phase() -> dict:
    """Phase 12: both ResNet50 models through cli.predict.infer on cuda."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli.predict import infer
    from artgraph_tpu_torch.models import (NewMultiModalMultiTask,
                                           ResnetSingleTask)

    expect = dict.fromkeys(_all_counts(), 0)
    expect["normalize_images"] = BATCHES
    specs = [
        ("ResnetSingleTask", lambda: ResnetSingleTask(32), 0),
        ("NewMultiModalMultiTask",
         lambda: NewMultiModalMultiTask(config.EMB_SIZE, config.NUM_CLASSES),
         2),
    ]
    rng = np.random.default_rng(SEED + 70)
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, ctor, n_emb) in enumerate(specs):
            path = os.path.join(tmp, f"{name}.pt")
            torch.save(_seeded_resnet_(ctor(), SEED + 70 + i).state_dict(),
                       path)
            model = load_reference_checkpoint(name, path, "cuda")
            batches = [
                (torch.from_numpy(rng.integers(0, 256, (B, 224, 224, 3),
                                               dtype=np.uint8)).cuda(),
                 *[torch.from_numpy(rng.normal(size=(B, config.EMB_SIZE))
                                    .astype(np.float32)).cuda()
                   for _ in range(n_emb)])
                for _ in range(BATCHES)]
            infer(model, *batches[0], transform_type="resnet")   # warm-up
            torch.cuda.synchronize()

            _zero_counts()
            t0 = time.perf_counter()
            outs = [infer(model, *batch, transform_type="resnet")
                    for batch in batches]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _all_counts()
            if counts != expect:
                raise AssertionError(f"{name}: launch counts {counts}, "
                                     f"expected {expect}")
            launches += counts["normalize_images"]
            outs = [o if isinstance(o, list) else [o] for o in outs]
            for logits in (t for o in outs for t in o):
                if logits.dtype != torch.float32 or logits.shape[0] != B \
                        or not torch.isfinite(logits).all():
                    raise AssertionError(
                        f"{name}: bad logits {logits.dtype} "
                        f"{tuple(logits.shape)}")
            cpu = load_reference_checkpoint(name, path, "cpu",
                                            dtype=torch.float32)
            ref = infer(cpu, *[t[:2].cpu() for t in batches[0]],
                        transform_type="resnet")
            ref = ref if isinstance(ref, list) else [ref]
            rel = max((o[:2].cpu() - r).norm().item() / r.norm().item()
                      for o, r in zip(outs[0], ref))
            print(f"resnet serve: {name} ResNet50 bf16 on cuda, {BATCHES} "
                  f"batches of {B}: {BATCHES * B / seconds:.1f} img/s, "
                  f"launches {counts}, rel L2 vs f32 CPU plain on 2 images "
                  f"{rel:.4g}", flush=True)
            if not rel <= E2E_REL_L2:
                raise AssertionError(f"{name}: rel L2 {rel} > {E2E_REL_L2}")
            # three batches are ~50 ms of host clock: the rate to quote is
            # the median of longer windows of the same batches
            rates = []
            for _ in range(SERVE_WINDOWS):
                t0 = time.perf_counter()
                for j in range(SERVE_WINDOW_BATCHES):
                    infer(model, *batches[j % BATCHES],
                          transform_type="resnet")
                torch.cuda.synchronize()
                rates.append(SERVE_WINDOW_BATCHES * B
                             / (time.perf_counter() - t0))
            print(f"resnet serve: {name} ResNet50 bf16 on cuda: "
                  f"{float(np.median(rates)):.1f} img/s (median of "
                  f"{SERVE_WINDOWS} windows of {SERVE_WINDOW_BATCHES} batches "
                  f"of {B}: {[round(r, 1) for r in rates]})", flush=True)
            del model, cpu
            torch.cuda.empty_cache()
    return {"normalize_images": launches}


@contextlib.contextmanager
def _conv_bn_gate(on: bool):
    """ARTGRAPH_CONVBN=1 (the fused unit's switch) set or unset inside."""
    saved = os.environ.pop("ARTGRAPH_CONVBN", None)
    if on:
        os.environ["ARTGRAPH_CONVBN"] = "1"
    try:
        yield
    finally:
        os.environ.pop("ARTGRAPH_CONVBN", None)
        if saved is not None:
            os.environ["ARTGRAPH_CONVBN"] = saved


def _resnet_train_steps(gate: bool) -> tuple[dict, float]:
    """TRAIN_WARMUP + TRAIN_STEPS Adam steps of ResnetSingleTask(32) at
    batch 32 on cuda, the fused unit's gate as given; (counts, img/s)."""
    from artgraph_tpu_torch.cli._common import single_task_loss
    from artgraph_tpu_torch.models import ResnetSingleTask
    from artgraph_tpu_torch.train import Trainer, adam

    model = _seeded_resnet_(ResnetSingleTask(32, dropout=0.4), SEED + 80)
    trainer = Trainer(model, adam(3e-4), single_task_loss(None),
                      transform_type="resnet", device="cuda")
    rng = np.random.default_rng(SEED + 81)
    batch = (rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8),
             rng.integers(0, 32, B).astype(np.int32), np.ones(B, np.float32))
    trainer.model.train()

    def step():
        return trainer.train_step(trainer.to_device(batch))[0]

    label = "on" if gate else "off"
    with _conv_bn_gate(gate):
        torch.cuda.reset_peak_memory_stats()
        losses = [step() for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        losses += [step() for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _all_counts()
        expect = dict.fromkeys(counts, 0)
        expect["normalize_images"] = TRAIN_STEPS
        if gate:
            expect["conv1x1_bn_stats"] = RESNET_UNITS * TRAIN_STEPS
            expect["conv1x1_bn_stats_bwd"] = RESNET_UNITS * TRAIN_STEPS
        if counts != expect:
            raise AssertionError(f"resnet train (gate {label}): launch "
                                 f"counts {counts}, expected {expect}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = torch.stack(losses).tolist()
        img_s = TRAIN_STEPS * B / seconds
        print(f"resnet train: ResnetSingleTask(32) ResNet50 bf16, adam(3e-4), "
              f"dropout 0.4, batch {B} on cuda, ARTGRAPH_CONVBN gate {label}: "
              f"{TRAIN_STEPS} steps in {seconds:.4f} s, {img_s:.1f} img/s, "
              f"{1e3 * seconds / TRAIN_STEPS:.3f} ms/step; peak memory "
              f"{peak_gb:.2f} GB (max_memory_allocated); launches {counts}; "
              f"losses {[round(v, 4) for v in losses]}", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"resnet train: losses not finite and "
                                 f"falling: {losses}")
        # the step is host-bound: the device time by gate is the comparison
        # that the launches do not blur
        _profile_steps(step, PROFILED_STEPS, 1e3 * seconds / TRAIN_STEPS,
                       label=f"resnet gate {label}")
    del trainer, model
    torch.cuda.empty_cache()
    return counts, img_s


def resnet_train_phase() -> dict:
    """Phase 13: ResNet50 training with the fused unit, then without."""
    counts, on = _resnet_train_steps(gate=True)
    _, off = _resnet_train_steps(gate=False)
    print(f"resnet train: gate on {on:.1f} img/s against gate off {off:.1f} "
          f"img/s ({on / off:.4f}x)", flush=True)
    return counts


def _bn_updates(model, before: dict) -> torch.Tensor:
    """The BN running statistics' change in one step, concatenated (f64)."""
    return torch.cat([(t.detach().cpu().double() - before[n]).flatten()
                      for n, t in model.named_buffers() if "running" in n])


@contextlib.contextmanager
def _units_held_to_plain(worst: dict):
    """Inside, every launch of the fused unit's kernels is held against the
    plain twin on the same in-situ inputs (_unit_error; y and dx with atol
    KERNEL_TOL x mean|plain|, since a step's dx is far below one); `worst`
    collects each output's largest measure and the calls checked."""
    from artgraph_tpu_torch.ops import conv_bn as U

    fwd, bwd = U.conv1x1_bn_stats_cuda, U.conv1x1_bn_stats_bwd_cuda

    def hold(names, ours, refs, prologue):
        for name, o, r in zip(names, ours, refs):
            atol = KERNEL_TOL * r.double().abs().mean().item()
            _, held, value, limit = _unit_error(name, o, r, prologue, atol)
            if not value <= limit:
                raise AssertionError(f"resnet grads: conv1x1_bn_stats {name} "
                                     f"{tuple(o.shape)} in the step: {held} "
                                     f"{value} > {limit}")
            worst[name] = max(worst.get(name, 0.0), value)

    def checked_fwd(x, a, b, w, prologue):
        out = fwd(x, a, b, w, prologue)
        hold(UNIT_OUTPUTS[:3], out,
             U.conv1x1_bn_stats_plain(x, a, b, w, prologue), prologue)
        worst["forward calls"] = worst.get("forward calls", 0) + 1
        return out

    def checked_bwd(x, a, b, w, y, dy, ds1, ds2, prologue):
        out = bwd(x, a, b, w, y, dy, ds1, ds2, prologue)
        hold(UNIT_OUTPUTS[3:], out, U.conv1x1_bn_stats_bwd_plain(
            x, a, b, w, y, dy, ds1, ds2, prologue), prologue)
        worst["backward calls"] = worst.get("backward calls", 0) + 1
        return out

    U.conv1x1_bn_stats_cuda, U.conv1x1_bn_stats_bwd_cuda = (checked_fwd,
                                                            checked_bwd)
    try:
        yield worst
    finally:
        U.conv1x1_bn_stats_cuda, U.conv1x1_bn_stats_bwd_cuda = fwd, bwd


def _resnet_step(src, device: str, dtype: torch.dtype, gate: bool, images,
                 labels, held: dict | None = None) -> dict:
    """One train-mode forward and backward of a copy of `src` (dropout 0)
    on `device` in `dtype` with the fused unit's gate as given: the loss,
    the logits, the trunk and head gradients and the BN statistics'
    updates, in f64 on the CPU; and the unit's launches. With `held`, each
    launch of the unit is held against its plain twin (_units_held_to_plain).
    """
    from artgraph_tpu_torch.models import ResnetSingleTask
    from artgraph_tpu_torch.ops import normalize_images
    from artgraph_tpu_torch.train import cross_entropy

    before = {n: b.double().clone() for n, b in src.named_buffers()
              if "running" in n}
    model = ResnetSingleTask(32, dropout=0.0, dtype=dtype)
    model.load_state_dict(src.state_dict())
    model = model.to(device).train()
    _zero_counts()
    check = (_units_held_to_plain(held) if held is not None
             else contextlib.nullcontext())
    with _conv_bn_gate(gate), check:
        logits = model(normalize_images(images.to(device), "resnet"))
        loss = cross_entropy(logits, labels.to(device))
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    if any(g is None or not torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError(f"resnet grads: a parameter on {device} has no "
                             f"finite gradient")
    cat = lambda pre: torch.cat([g.to("cpu", torch.float64).flatten()
                                 for n, g in grads.items()
                                 if n.startswith(pre)])
    return {"loss": loss.detach().double().cpu().reshape(1),
            "logits": logits.detach().double().cpu(),
            "trunk gradient": cat("resnet."),
            "head gradient": cat("classifier."),
            "BN statistics' updates": _bn_updates(model, before),
            "units": _read_counts(_conv_bn_counters)}


def resnet_grad_phase() -> None:
    """Phase 14: one step with the unit in bf16 on the card against the
    unfused f32 path on the CPU; then one ragged step.

    Each of the step's 32 forward and 32 backward unit launches is held
    against the plain twin on its own in-situ inputs, at the kernel
    tolerances. The gradient of a ResNet50 at random initialization in
    train-mode BatchNorm is chaotic (BatchNorm's gradient explosion at
    initialization): on these inputs the CPU's own f32 trunk gradient lies
    ~2e-2 from its f64 one, and the unfused bf16 path, no kernel involved,
    ~1.4 from the f32 one; the JAX package's own bf16 step lies as far from
    its f32 one (tests/test_torch_resnet.py::
    test_bf16_trunk_gradient_distance_matches_jax). So end to end each
    quantity q is held to
        rel L2(card bf16 with the unit, CPU f32)
            <= max(TRAIN_GRAD_REL_L2, BF16_FLOOR_FACTOR * rel L2(CPU bf16
               unfused, CPU f32)):
    the unit adds no more error than bf16 PyTorch itself on this model.
    """
    from artgraph_tpu_torch.models import ResnetSingleTask
    from artgraph_tpu_torch.ops import normalize_images
    from artgraph_tpu_torch.train import Trainer, cross_entropy, sgd_momentum

    rng = np.random.default_rng(SEED + 90)
    n_img = 4
    images = torch.from_numpy(rng.integers(0, 256, (n_img, 224, 224, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 32, n_img))
    src = _seeded_resnet_(ResnetSingleTask(32), SEED + 91)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    held: dict = {}
    card = _resnet_step(src, "cuda", torch.bfloat16, True, images, labels,
                        held)
    ref = _resnet_step(src, "cpu", torch.float32, False, images, labels)
    floor = _resnet_step(src, "cpu", torch.bfloat16, False, images, labels)
    calls = (held.get("forward calls"), held.get("backward calls"))
    if card["units"] != dict.fromkeys(card["units"], RESNET_UNITS) or \
            calls != (RESNET_UNITS, RESNET_UNITS):
        raise AssertionError(f"resnet grads: unit launches {card['units']}, "
                             f"held to the plain twin {held}, expected "
                             f"{RESNET_UNITS} each")
    print(f"resnet grads: the step's unit launches, each against its plain "
          f"twin on its own inputs on the card (y, dx: worst err/(atol+rtol"
          f"|ref|) at rtol {KERNEL_TOL}, atol {KERNEL_TOL} x mean|ref|, "
          f"limit 1; s1, s2, dw, da, db: worst rel L2, limit {GRAD_REL_L2}; "
          f"da, db without the prologue exactly 0): "
          f"{ {k: round(v, 6) for k, v in held.items()} }", flush=True)
    parts = []
    for q in ("loss", "logits", "head gradient", "trunk gradient",
              "BN statistics' updates"):
        got, base = rel(card[q], ref[q]), rel(floor[q], ref[q])
        bound = max(TRAIN_GRAD_REL_L2, BF16_FLOOR_FACTOR * base)
        parts.append(f"{q} {got:.4g} (unfused bf16 on the CPU {base:.4g}, "
                     f"bound {bound:.4g})")
        if not got <= bound:
            raise AssertionError(f"resnet grads: {q} rel L2 {got} > {bound}")
    print(f"resnet grads: one step on {n_img} images, ResNet50, the unit in "
          f"bf16 on cuda ({card['units']}) vs unfused f32 on the CPU, rel "
          f"L2: {'; '.join(parts)}", flush=True)

    # a ragged batch: the last half of the rows are padding
    valid = n_img // 2
    mask = np.zeros(n_img, np.float32)
    mask[:valid] = 1.0
    before = {n: b.double().clone() for n, b in src.named_buffers()
              if "running" in n}
    model = ResnetSingleTask(32, dropout=0.0)
    model.load_state_dict(src.state_dict())
    trainer = Trainer(model, sgd_momentum(1e-3),
                      lambda out, b: (cross_entropy(out, b[1], mask=b[2]),
                                      {}),
                      transform_type="resnet", device="cuda")
    _zero_counts()
    with _conv_bn_gate(True):
        trainer.train_step(trainer.to_device(
            (images.numpy(), labels.numpy(), mask)), ragged=True)
    torch.cuda.synchronize()
    counts = _read_counts(_conv_bn_counters)
    if any(counts.values()):
        raise AssertionError(f"resnet ragged step: unit launches {counts}")
    updates = {}
    for dtype in (torch.float32, torch.bfloat16):
        cpu = ResnetSingleTask(32, dropout=0.0, dtype=dtype)
        cpu.load_state_dict(src.state_dict())
        with torch.no_grad():
            cpu.train()(normalize_images(images[:valid], "resnet"))
        updates[dtype] = _bn_updates(cpu, before)
    got = rel(_bn_updates(trainer.model, before), updates[torch.float32])
    base = rel(updates[torch.bfloat16], updates[torch.float32])
    bound = max(TRAIN_GRAD_REL_L2, BF16_FLOOR_FACTOR * base)
    print(f"resnet grads: one ragged step ({valid} of {n_img} rows valid) on "
          f"cuda, gate open: unit launches {counts}; BN statistics' updates "
          f"vs the f32 CPU path over the {valid} valid rows: rel L2 "
          f"{got:.4g} (unfused bf16 on the CPU {base:.4g}, bound "
          f"{bound:.4g})", flush=True)
    if not got <= bound:
        raise AssertionError(f"resnet ragged step: rel L2 {got} > {bound}")


def resnet_cli_phase(checkpoints_dir: Path) -> None:
    """Phase 15: cli.train_baseline --architecture resnet on cuda with the
    fused unit, a ragged last batch."""
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli import train_baseline

    spec = importlib.util.spec_from_file_location(
        "_make_synth", REPO / "tests" / "_make_synth.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    batch = 10
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        counts = synth.make_image_tree(root)
        if not counts["train"] % batch:
            raise AssertionError("resnet cli: the last batch is not ragged")
        out = io.StringIO()
        _zero_counts()
        t0 = time.perf_counter()
        with _conv_bn_gate(True), contextlib.redirect_stdout(out):
            acc = train_baseline.main([
                "--dataset_path", str(root / "dataset"),
                "--image_path", str(root / "images"),
                "--architecture", "resnet", "--label", "style", "--epochs",
                "1", "--batch", str(batch), "--num_workers", "4",
                "--device", "cuda", "--results_dir", str(root / "results")])
        seconds = time.perf_counter() - t0
        units = _read_counts(_conv_bn_counters)
        text = out.getvalue()
        for line in text.splitlines():
            print(f"resnet cli: {line}")
        for want in ("Train loss: ", "Validation loss: ",
                     f"Test accuracy: {acc}"):
            if want not in text:
                raise AssertionError(f"resnet cli: no line with {want!r}")
        full = counts["train"] // batch
        if units != dict.fromkeys(units, RESNET_UNITS * full):
            raise AssertionError(f"resnet cli: unit launches {units}, "
                                 f"expected {RESNET_UNITS * full} each (the "
                                 f"{full} full batches)")
    path = checkpoints_dir / "style_resnet_baseline_single-task_checkpoint.pt"
    model = load_reference_checkpoint("ResnetSingleTask", str(path), "cuda")
    print(f"resnet cli: train_baseline --architecture resnet --device cuda "
          f"ARTGRAPH_CONVBN=1, 1 epoch on {counts} synthetic images at "
          f"--batch {batch} in {seconds:.1f} s; unit launches {units}; "
          f"checkpoint {path.name} reloaded strict "
          f"({len(model.state_dict())} tensors); test accuracy {acc}",
          flush=True)


def _unfused_vit(model: torch.nn.Module) -> torch.nn.Module:
    """The model with its `.vit` trunk replaced by ViT(fuse_qkv=False) in
    the same dtype (the head kept), loaded strict from its own state_dict."""
    from artgraph_tpu_torch.models import ViT

    state = model.state_dict()
    vit = ViT(dtype=model.vit.dtype, fuse_qkv=False)
    vit.head = model.vit.head
    model.vit = vit
    model.load_state_dict(state, strict=True)
    return model


def vit_unfused_serve_phase() -> dict:
    """Phase 16: the ViTSingleTask trunk of phase 5's weights, loaded strict
    into ViT(fuse_qkv=False) at full ViT-B/16 width and depth, on cuda."""
    from artgraph_tpu_torch.models import ViT, ViTSingleTask, init_random_
    from artgraph_tpu_torch.ops import normalize_images

    src = init_random_(ViTSingleTask(32), torch.Generator().manual_seed(SEED))
    trunk = {k[4:]: v for k, v in src.state_dict().items()
             if k.startswith("vit.") and not k.startswith("vit.head.")}
    del src
    models = {}
    for label, fuse_qkv, device, dtype in (
            ("unfused", False, "cuda", torch.bfloat16),
            ("fused", True, "cuda", torch.bfloat16),
            ("cpu f32", False, "cpu", torch.float32)):
        vit = ViT(dtype=dtype, fuse_qkv=fuse_qkv)
        vit.load_state_dict(trunk, strict=True)
        models[label] = vit.to(device).eval()
    rng = np.random.default_rng(SEED + 90)
    batches = [normalize_images(torch.from_numpy(rng.integers(
        0, 256, (B, 224, 224, 3), dtype=np.uint8)).cuda(), "vit")
        for _ in range(BATCHES)]
    model = models["unfused"]
    with torch.inference_mode():
        model(batches[0])                    # warm-up, before the count
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        outs = [model(x) for x in batches]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _all_counts()
        expect = dict.fromkeys(counts, 0)
        expect["fused_attention"] = 12 * BATCHES
        if counts != expect:
            raise AssertionError(f"vit unfused serve: launch counts {counts}, "
                                 f"expected {expect}")
        if any(o.shape != (B, C) or not torch.isfinite(o).all()
               for o in outs):
            raise AssertionError("vit unfused serve: pooled features not "
                                 "finite [B, 768]")
        two = batches[0][:2]
        fused = models["fused"](two).cpu()
        ref = models["cpu f32"](two.cpu())
    ours = outs[0][:2].cpu()
    rel = {"f32 CPU plain": (ours - ref).norm().item() / ref.norm().item(),
           "fused-block trunk": ((ours - fused).norm().item()
                                 / fused.norm().item())}
    print(f"vit unfused serve: ViT(fuse_qkv=False) ViT-B/16 bf16 on cuda, "
          f"{BATCHES} batches of {B} normalized images: "
          f"{BATCHES * B / seconds:.1f} img/s; launches "
          f"{ {k: n for k, n in counts.items() if n} } (every other kernel "
          f"0); pooled features on 2 images, rel L2 vs "
          f"{ {k: float(f'{v:.4g}') for k, v in rel.items()} } (bound "
          f"{E2E_REL_L2})", flush=True)
    if not all(v <= E2E_REL_L2 for v in rel.values()):
        raise AssertionError(f"vit unfused serve: rel L2 {rel} > "
                             f"{E2E_REL_L2}")
    del models, model, batches, outs
    torch.cuda.empty_cache()
    return {k: counts[k] for k in _mha_counters()}


def vit_unfused_train_phase() -> dict:
    """Phase 17: phase 6's training steps with the ViT(fuse_qkv=False) trunk,
    then phase 7's gradient check on that trunk."""
    from artgraph_tpu_torch.cli._common import single_task_loss
    from artgraph_tpu_torch.models import ViTSingleTask, init_random_
    from artgraph_tpu_torch.train import Trainer, adam

    model = _unfused_vit(init_random_(ViTSingleTask(32, dropout=0.4),
                                      torch.Generator().manual_seed(
                                          SEED + 10)))
    trainer = Trainer(model, adam(3e-4), single_task_loss(None),
                      transform_type="vit", device="cuda")
    rng = np.random.default_rng(SEED + 2)
    batch = (rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8),
             rng.integers(0, 32, B).astype(np.int32),
             np.ones(B, np.float32))
    trainer.model.train()

    def step():
        return trainer.train_step(trainer.to_device(batch))[0]

    losses = [step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses += [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _all_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(fused_attention=12 * TRAIN_STEPS,
                  fused_attention_bwd=12 * TRAIN_STEPS,
                  normalize_images=TRAIN_STEPS)
    if counts != expect:
        raise AssertionError(f"vit unfused train: launch counts {counts}, "
                             f"expected {expect}")
    losses = torch.stack(losses).tolist()
    print(f"vit unfused train: ViTSingleTask(32) with ViT(fuse_qkv=False), "
          f"bf16, adam(3e-4), dropout 0.4, batch {B} on cuda: {TRAIN_STEPS} "
          f"steps in {seconds:.3f} s, {TRAIN_STEPS * B / seconds:.1f} img/s, "
          f"{1e3 * seconds / TRAIN_STEPS:.2f} ms/step; launches "
          f"{ {k: n for k, n in counts.items() if n} } (every other kernel "
          f"0); losses {[round(v, 4) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"vit unfused train: losses not finite and "
                             f"falling: {losses}")
    _profile_steps(step, PROFILED_STEPS, 1e3 * seconds / TRAIN_STEPS,
                   label="vit unfused train")
    del trainer, model
    torch.cuda.empty_cache()
    grad_phase(unfused=True)
    return {k: counts[k] for k in (*_mha_counters(), "normalize_images")}


def attention_module_phase() -> dict:
    """Phase 18: the standalone Attention(768, 12, fuse_qkv=True), the
    counterpart of the JAX package's attention_module_x12 profile
    (bench.py:525): 12 forward + backward calls on x [32, 197, 768] bf16,
    then one call's dx and parameter gradients against the f32 plain path
    on the CPU."""
    import copy

    from artgraph_tpu_torch.models import init_random_
    from artgraph_tpu_torch.models.vit import Attention

    calls = 12
    src = init_random_(Attention(C, H, fuse_qkv=True),
                       torch.Generator().manual_seed(SEED + 100))
    rng = np.random.default_rng(SEED + 100)
    x = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)) \
        .to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32))
    mod = copy.deepcopy(src).cuda()
    xc = x.cuda().requires_grad_()
    gc = g.cuda().to(torch.bfloat16)

    def call():
        mod(xc).backward(gc)

    call()                                   # warm-up, before the count
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _all_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(fused_qkv_attention=calls, fused_qkv_attention_bwd=calls)
    if counts != expect:
        raise AssertionError(f"attention module: launch counts {counts}, "
                             f"expected {expect}")

    grads = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        m = copy.deepcopy(src).to(device)
        xs = x.to(device, dtype, copy=True).requires_grad_()
        m(xs).backward(g.to(device, dtype))
        grads[device] = {"dx": xs.grad, **{
            f"d{n}": p.grad for n, p in m.named_parameters()}}
    parts = []
    for name, r in grads["cpu"].items():
        a = grads["cuda"][name].to("cpu", torch.float64)
        r = r.double()
        note = ""
        if name == "dqkv.bias":
            k_err, a, r = _k_third("attention module", a, r)
            note = f" (K third max abs {k_err:.4g})"
        rel = ((a - r).norm() / r.norm()).item()
        parts.append(f"{name} {rel:.4g}{note}")
        if not (rel <= TRAIN_GRAD_REL_L2 and torch.isfinite(a).all()):
            raise AssertionError(f"attention module {name}: rel L2 {rel} > "
                                 f"{TRAIN_GRAD_REL_L2}")
    print(f"attention module: Attention({C}, {H}, fuse_qkv=True) on x "
          f"[{B}, {N}, {C}] bf16 on cuda: {calls} forward + backward calls "
          f"in {seconds:.4f} s, {1e3 * seconds / calls:.3f} ms per call; "
          f"launches {counts['fused_qkv_attention']} + "
          f"{counts['fused_qkv_attention_bwd']}, every other kernel 0; one "
          f"call vs f32 plain on the CPU, rel L2: {', '.join(parts)} (bound "
          f"{TRAIN_GRAD_REL_L2})", flush=True)
    del mod, xc, gc
    torch.cuda.empty_cache()
    return {k: counts[k] for k in _mha_counters()}


def main() -> int:
    device_phase()
    sys.path.insert(0, str(REPO))
    checkpoints_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    # read by artgraph_tpu_torch.config when the port is first imported
    os.environ["ARTGRAPH_CHECKPOINTS_DIR"] = str(checkpoints_dir)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build_phase()
        kernels = kernel_phases()
        kernels.update(csr_kernel_phases())
        kernels.update(conv_bn_kernel_phases())
        kernels.update(attention_kernel_phases())
        launches = serve_phase()
        for k, n in train_phase().items():
            launches[k] += n
        grad_phase()
        cli_phase(checkpoints_dir)
        launches.update(gnn_train_phase())
        gnn_grad_phase()
        gnn_cli_phase()
        launches["normalize_images"] += \
            resnet_serve_phase()["normalize_images"]
        for k, n in resnet_train_phase().items():
            launches[k] = launches.get(k, 0) + n
        resnet_grad_phase()
        resnet_cli_phase(checkpoints_dir)
        for phase in (vit_unfused_serve_phase, vit_unfused_train_phase,
                      attention_module_phase):
            for k, n in phase().items():
                launches[k] = launches.get(k, 0) + n
    finally:
        shutil.rmtree(checkpoints_dir, ignore_errors=True)
    for name, n in launches.items():
        kernels[name]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
