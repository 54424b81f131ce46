#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ViT-B/16 serving and training paths, its
KG-embedding stage (the hetero-GAT of train_gnn_embeddings), its ResNet50
serving and training paths, the unfused ViT-B/16 trunk (ViT(fuse_qkv=False))
and the standalone Attention module, the training of the fusion model
NewMultiModalMultiTaskViT, the four pipeline stages through their CLIs, the
ContextNet and MultiModal context models' training, the three baseline
CLIs, the Trainer's graphed step and its device-resident epochs, the
trainers' run control (--resume, --init_checkpoint, -t) and data
parallelism (--data_parallel, the edge-sharded GNN) once on one NVIDIA
GPU.

    python3 chip_smoke.py          # from the root of a checkout

It imports nothing of JAX or of the JAX package; PIL only in the CLI phases
(data decode), pandas there and with the KG container of the GNN phases. Phases, each printing its lines; any failure raises and exits
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
              (bf16 dense) and its bytes at 3.35 TB/s, from the shapes.
              Before them the block GEMM alone (csrc/block_gemm.cu, in rows
              1, 1b, 2, 2b, 5, 5b): each ViT-B/16 call of it through
              gemm_cuda (VIT_GEMMS) held against gemm_plain (bf16 at
              rtol = atol = 3e-2, f32 at relative L2 <= GRAD_REL_L2,
              bit-identical on repeat) and timed, with its TFLOP/s and the
              time of torch.matmul on the same bf16 operands beside
              (gemm_kernel_phases). Then the row and column reductions
              of rows 1b, 2b and 5b alone (csrc/block_norm_bwd.cu): the
              LayerNorm backward at [B*N, C] against ln_bwd_plain (dx at
              rtol = atol = 3e-2; dgamma, dbeta and db_res, the residual
              bias's column sum, at relative L2 <= GRAD_REL_L2) and the
              column sums at [B*N, 3C], [B*N, 3072] and [B*N, C] against
              the f32 column sum, bit-identical on repeat, each timed
              beside its plain version, its byte bound and a library call
              (native_layer_norm_backward on f32 copies plus the residual
              add; torch.sum in f32); and the LayerNorm forward of
              block_gemm.cu the same way beside F.layer_norm
              (norm_kernel_phases)
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
call; timed beside the plain twins and torch.matmul with the column sums,
the backward also beside a full-function yardstick (dyt, the prologue, two
torch.matmul and the two column sums), and each direction's device time
broken down by launch (torch.profiler) (conv_bn_kernel_phases); and the kernels of fused_attention and
fused_qkv_attention, forward and backward, at B=32, N=197, H=12, D=64 (q, k,
v strided views of one [B, N, 3, H, D] bf16 tensor, never copied; x
[B, N, 768]) against their plain twins on the card: outputs, dq/dk/dv and
dx at rtol = atol = 3e-2, the f32 dw and db as in phase 3 (the K third of
db by absolute error), bit-identical on repeat; fused_attention forward and
backward also at N = 600 on 2 images x 2 heads against the twins, the same
way; timed beside the twins and F.scaled_dot_product_attention (after
F.linear for the qkv op; autograd of the same for the backwards)
(attention_kernel_phases). Then rows 9 and 3 alone by device time
(scalar_normalize_phases): the CSR scalar sum over E = 1M edges into 32
`style` hubs, 100K artworks and 18 `genre` hubs (f32 against the plain twin
in f64 at rtol = 1e-4, atol = 1e-3, bit-identical on repeat; the artworks'
CSR, which takes 4 lanes a chunk, also timed at 32), and the uint8
normalize at [32, 224, 224, 3], each by the profiler's device time over
inputs rotated past the L2, with the CUDA-event time, plain, library and
bound beside (as norm_kernel_phases). Phase 9's profile prints the scalar
sum's device time and launches a step.

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
 19. multimodal train  the reference's best model,
              NewMultiModalMultiTaskViT(128, {style: 32, genre: 18}) at full
              ViT-B/16 width, seeded random weights, dropout 0.4, adam(3e-4),
              multi_task_loss(None, None, 0.5, 0.5), batch 32 of uint8 images
              and two f32 [32, 128] embeddings, through the Trainer with
              forward_inputs (images, emb_style, emb_genre): as phase 6, 2
              warm-up and 8 timed steps (12 forward and 12 backward launches
              of each block kernel a step, 1 normalize), losses finite and
              falling, img/s, peak memory, 2 profiled steps, and img/s and
              device ms a step beside phase 6's; then one step on 4 images at
              dropout 0 against the f32 plain path on the CPU: the loss, both
              heads' logits and gradients and the trunk gradient at relative
              L2 <= TRAIN_GRAD_REL_L2, each block's K third of db_qkv by
              absolute error.
 20. pipeline cli  the four stages through the CLIs with --device cuda at
              full model width, on a synthetic image tree
              (tests/_make_synth.py) and a KG written here:
              train_gnn_embeddings; train_projector (ResNet50,
              ARTGRAPH_CONVBN=1: the unit's launches on the full batches
              only) and train_projector --architecture vit into a directory
              of its own; generate_projections (files [N, 128], row-aligned,
              within E2E_REL_L2 of a direct forward of the reloaded
              projector on the card); train_new_multimodal_multitask
              --architecture vit on the train table tiled to the image rows
              and the projections (results_style.csv, results_genre.csv);
              train_new_multimodal (ResNet50, gate open) on the same files.
              Each stage's lines, its launches of every kernel, and its
              checkpoint reloaded strict through load_reference_checkpoint.
 21. context train  ContextNetSingleTask(128, 18) (sgd_momentum(3e-4),
              SmoothL1, lamb 0.9) and MultiModalMultiTask(128, {style: 32,
              genre: 18}) (adam(3e-4), MSE, lamb 0.6, head dropout 0.2) at
              full ResNet50 size, seeded weights, the joint loss of
              train_baseline_context{,_multitask}, batch 32 of uint8 images
              and an f32 [32, 128] embedding, ARTGRAPH_CONVBN=1: as phase
              13, 2 warm-up and 8 timed steps (32 forward and 32 backward
              unit launches and 1 normalize a step), losses finite and
              falling, img/s, 2 profiled steps, and img/s and device ms a
              step beside phase 13's gated ResnetSingleTask; one step on 4
              images (head dropout 0) as phase 14: each unit launch against
              its plain twin, and the loss, logits, graph_proj, head and
              trunk gradients and BN statistics' updates against the
              unfused f32 CPU path at phase 14's bound; one ragged step (no
              unit launch); the model saved as a reference .pt and reloaded
              strict (named `resnet.conv1.*` trunk keys for MultiModal,
              indexed `resnet.0.*` for ContextNet).
 22. baseline cli  train_baseline_multitask --architecture resnet (gate
              open) and --architecture vit, train_baseline_context --net
              context-net and --net multi-modal, and
              train_baseline_context_multitask --net multi-modal, with
              --device cuda, 1 epoch at --batch 10 (the last batch ragged)
              on a synthetic image tree (tests/_make_synth.py) with a train
              embedding table written beside it: each run's lines, every
              kernel's launches (the unit on the full train batches only),
              its checkpoint reloaded strict and its results CSVs.

 23. graph train  the Trainer's graphed step (one CUDA graph a step:
              normalize, forward, loss, backward, the optimizer step, the
              metric totals) for phase 6's ViT, phase 13's ResNet50 with the
              gate open and closed, phase 19's fusion ViT and phase 21's
              ContextNet: at dropout 0 (cuDNN deterministic), 4 full batches
              and a ragged one through train_epoch (the first the eager
              warm-up, then replays; a BatchNorm model's ragged batch eager
              under its mask) against eager train_step on the same batches
              from the same weights: per-step losses, parameters and BN
              buffers bit-identical, or within relative L2 GRAPH_REL_L2
              (printed which); the counters per replay equal to the
              kernels' launches a step, and the profiler's count of each of
              the port's kernels per replay equal to an eager step's and to
              the counters (the normalize kernel, the attention core twice
              per block, dK/dV and the LayerNorm backward per backward, the
              unit's forward and weight-gradient products); then at the
              phases' dropout graphed against eager in turns
              (GRAPH_WINDOWS windows of GRAPH_WINDOW_STEPS steps each way,
              medians): ms a step, img/s, device busy ms and idle share,
              each trainer's peak allocated and held memory.
 24. resident  RESIDENT_IMAGES seeded 224 px images (154 MB) held on the
              card by a ResidentLoader, its batches equal to the host
              loader's (valid rows, masks); ResNet50 (gate on) and ViT-B/16
              at dropout 0, 3 epochs each three ways: the epoch from the
              index and mask matrices, the per-batch device stream
              (epoch_scan=False), the host loader with prefetch; epoch
              losses equal across the ways, the second epoch's seconds and
              img/s, the third's host-to-device copies by the profiler (the
              index and mask matrices only on the resident ways); then
              cli.train_baseline --architecture resnet (gate open) and vit
              with --resident_data, --resident_data --no_epoch_scan and
              --image_cache on phase 15's synthetic tree: each run's lines,
              its launches (the unit on the full train batches only), its
              checkpoint reloaded strict.
 25. capture  rows 1, 1b, 2, 2b, 3, 10 and 10b (the unit at the three
              CONV_BN_SHAPES) each captured alone in a CUDA graph at the main
              path's shapes and replayed on new inputs copied into its
              static buffers: every output bit-identical to the eager launch
              on those inputs.
 26. run control  on phase 15's synthetic tree at --batch 10 (the last
              batch ragged), with cuDNN's deterministic algorithms, at the
              CLI's dropout (0.4): cli.train_baseline --architecture vit and
              --architecture resnet (gate open) with --epochs 3 --resume A,
              with --epochs 1 then --epochs 3 --resume B, and the same pair
              with --resident_data (R): B and R bit-identical to A (the best
              checkpoint, the final payload's parameters, BN buffers, Adam
              state, host step, early-stop state and generator state, the
              epochs' printed lines, the test accuracy), each run's launches
              exact, the restart's "resumed from" line; each resume save's
              bytes and seconds beside its epoch's seconds. A ViT run with
              -t into a file store: its metrics equal the printed values,
              its launches and lines equal the same run's without -t.
              cli.train_gnn_embeddings --epochs 6 then 8 with --resume on a
              KG written here: both embedding files bit-identical to an
              uninterrupted --epochs 8. --init_checkpoint from a seeded
              ViTSingleTask .pt saved by the port (full model), the same
              weights in raw timm layout and a seeded raw-torchvision
              ResNet50 trunk (trunk only): applied to the CLI's fresh model
              the imported tensors equal the file's, the fresh ones (the
              head) unchanged, the report's counts as expected; then each
              through cli.train_baseline for 1 epoch, which prints the same
              report, launches exact.
 27. data parallel  (a) ViTSingleTask ViT-B/16 and ResnetSingleTask
              ResNet50 (gate on) at dropout 0, batch 32: DP_STEPS steps of
              train_epoch over a one-rank NCCL mesh in this process (the
              graphed step with its collectives captured) against the
              one-device graphed step on the same batches, the losses,
              parameters and BN statistics within DP_REL_L2 or
              DP_FLOOR_FACTOR x their distance between two one-device runs
              whose batches differ only in row order; then both timed in
              turns: ms a step, device busy ms and idle share, NCCL's
              kernels' share of the busy time, launches a step. (b) two
              gloo ranks spawned on the one card, one eager step each on
              its 16 rows (ViT-B/16; ResNet50 in bf16 with the gate open
              and closed, and in f32) or its edge shard of the 8M-edge
              GNN, against the one-process step: the loss, trunk and head
              gradients and BN statistics' updates within the dtype's
              bound or DP_FLOOR_FACTOR x its own error on one process
              (bf16 against f32, f32 against f64: a random-init ResNet50's
              gradient is chaotic), the stem BN's updates within
              DP_STEM_REL, every kernel of each path launched on both
              ranks. (c) cli.train_baseline --architecture vit and
              cli.train_gnn_embeddings with --data_parallel 1 on cuda
              (one NCCL rank in a process of its own): the result, the
              checkpoint and the embeddings; --data_parallel 2 refused.

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


# The ViT-B/16 GEMM calls of the block ops through gemm_cuda at batch B:
# (what, layout, epilogue, M, N, K); NT: a [M, K], b [N, K]; NN: a [M, K],
# b [K, N]; TN (weight gradients): a [K, M], b [K, N].
_M = B * N
VIT_GEMMS = (
    ("qkv", 0, 0, _M, 3 * C, C),
    ("proj", 0, 2, _M, C, C),
    ("fc1", 0, 1, _M, HIDDEN, C),
    ("fc1 recompute", 0, 3, _M, HIDDEN, C),
    ("fc2", 0, 2, _M, C, HIDDEN),
    ("do.W_proj", 1, 4, _M, C, C),
    ("dqkv.W_qkv", 1, 5, _M, C, 3 * C),
    ("dqkv.W_qkv (qkv op dx)", 1, 4, _M, C, 3 * C),
    ("do.W2", 1, 6, _M, HIDDEN, C),
    ("dh.W1", 1, 5, _M, C, HIDDEN),
    ("dW_qkv", 2, 5, 3 * C, C, _M),
    ("dW_proj", 2, 5, C, C, _M),
    ("dW1", 2, 5, HIDDEN, C, _M),
    ("dW2", 2, 5, C, HIDDEN, _M),
)


def gemm_kernel_phases() -> None:
    """Phases 3 and 4 for the block GEMM (csrc/block_gemm.cu) alone: each
    ViT-B/16 call of VIT_GEMMS through gemm_cuda against gemm_plain on the
    same seeded inputs (bf16 outputs at rtol = atol = KERNEL_TOL, f32 at
    relative L2 <= GRAD_REL_L2), bit-identical on repeat; then its time,
    TFLOP/s and the time of torch.matmul on the same bf16 operands (a
    yardstick the port never calls, without the epilogue)."""
    from artgraph_tpu_torch.ops import attention as A

    rng = np.random.default_rng(SEED + 90)
    dev = lambda shape, scale=1.0: torch.from_numpy(
        (scale * rng.normal(size=shape)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
    for what, layout, epi, M, Nn, K in VIT_GEMMS:
        a = dev((K, M) if layout == A.LAYOUT_TN else (M, K))
        b = dev((Nn, K) if layout == A.LAYOUT_NT else (K, Nn),
                1.0 if layout == A.LAYOUT_TN else K ** -0.5)
        bias = dev((Nn,), 0.02).float() if epi <= A.EPI_BIAS_GELU_AUX \
            else None
        aux = dev((M, Nn)) if epi in (A.EPI_BIAS_RESIDUAL, A.EPI_DGELU) \
            else None
        label = (f"gemm {what} ({'NT NN TN'.split()[layout]}, epilogue "
                 f"{epi}, M={M} N={Nn} K={K})")
        run = lambda: A.gemm_cuda(a, b, layout, epi, bias=bias, aux=aux)
        ours, again = _as_tuple(run()), _as_tuple(run())
        torch.cuda.synchronize()
        ref = _as_tuple(A.gemm_plain(a, b, layout, epi, bias=bias, aux=aux))
        if not all(torch.equal(o, g) for o, g in zip(ours, again)):
            raise AssertionError(f"{label} differs from call to call")
        for o, r in zip(ours, ref):
            if epi == A.EPI_F32:
                rel = ((o.double() - r.double()).norm()
                       / r.double().norm()).item()
                print(f"check: {label} f32 vs plain: rel L2 {rel:.4g}; "
                      f"bit-identical on repeat", flush=True)
                if not (rel <= GRAD_REL_L2 and torch.isfinite(o).all()):
                    raise AssertionError(f"{label}: rel L2 {rel}")
            else:
                _check_output(label, o, r)
        matmul = {A.LAYOUT_NT: lambda: torch.matmul(a, b.t()),
                  A.LAYOUT_NN: lambda: torch.matmul(a, b),
                  A.LAYOUT_TN: lambda: torch.matmul(a.t(), b)}[layout]
        ms, lib_ms = _time_ms(run), _time_ms(matmul)
        flops = 2.0 * M * Nn * K
        print(f"time: {label} kernel {ms:.4f} ms, {flops / ms / 1e9:.1f} "
              f"TFLOP/s; torch.matmul {lib_ms:.4f} ms, "
              f"{flops / lib_ms / 1e9:.1f} TFLOP/s (median of 10 CUDA-event "
              f"timings of 10 calls)", flush=True)
        del a, b, bias, aux, ours, again, ref


def _rel_l2(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.double(), r.double()
    return ((a - r).norm() / r.norm()).item()


def _device_ms(fn, calls: int = 10, tries: int = 3) -> float | None:
    """Device ms per call of fn: its kernels', memcpys' and memsets' summed
    durations (torch.profiler), after one warm-up call. A profiler session
    now and then records no device event at all; such a session is run
    again, up to `tries` sessions in all, and None returned if none saw
    device time."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        work, _ = _device_work(fn, calls)
        ms = sum(ms for ms, _ in work.values())
        if ms > 0:
            return ms
    return None


def _rotating(make, inputs: list):
    """A call of make(*inputs[i]) for i = 0, 1, ... in turn: over copies of
    the inputs larger together than the 50 MB L2, each call reads its
    operands from device memory, as the block backward's launches do."""
    turn = iter(range(1 << 62))
    return lambda: make(*inputs[next(turn) % len(inputs)])


def _copies(nbytes: int) -> int:
    """Copies of nbytes of inputs that together exceed twice the L2."""
    return max(2, -(-100 * 2 ** 20 // nbytes))


def _time_line(label: str, run, plain, library, nbytes: float,
               copies: int) -> None:
    """Time a kernel beside its plain version and a library call: device ms
    per call (torch.profiler) of each, and the kernel's CUDA-event ms (10
    calls back to back, where the host's launch cost shows); with its byte
    bound (each input read once, each output written once, at the HBM
    rate). Where the profiler saw no device time for a function, its CUDA-
    event ms stands in and the line says so."""
    times, notes = [], []
    for what, fn in (("kernel", run), ("plain", plain),
                     ("library", library)):
        ms = _device_ms(fn)
        if ms is None:
            ms = _time_ms(fn)
            notes.append(f"{what}: the profiler saw no device time, CUDA "
                         "events stand in")
        times.append(ms)
    ms, plain_ms, lib_ms = times
    bound_ms, _ = _bound(0, nbytes)
    print(f"time: {label} kernel {ms:.4f} ms of device time ("
          f"{_time_ms(run):.4f} ms by CUDA events back to back), plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms (bytes), {100 * bound_ms / ms:.1f}% of the bound (inputs "
          f"rotated over {copies} copies: read from device memory)"
          + "".join(f"; {n}" for n in notes), flush=True)


def norm_kernel_phases() -> None:
    """Phases 3 and 4 for the row and column reductions of the block ops
    alone: csrc/block_norm_bwd.cu's LayerNorm backward (rows 1b, 2b, with
    db_res, the residual bias's column sum) at [B*N, C] against
    ln_bwd_plain (dx at rtol = atol = KERNEL_TOL, dgamma, dbeta and db_res
    at relative L2 <= GRAD_REL_L2) and its column sums (rows 1b, 2b, 5b) at
    [B*N, 3C] (dqkv), [B*N, HIDDEN] (dh) and [B*N, C] against the f32 column
    sum of the same tensor (relative L2 <= GRAD_REL_L2), each bit-identical
    on repeat; then block_gemm.cu's LayerNorm forward (rows 1, 1b, 2, 2b)
    against ln_rows_plain (rtol = atol = KERNEL_TOL), the same way. Each
    timed beside its plain version and a library call the port never makes
    (native_layer_norm_backward on f32 copies plus the residual add;
    torch.sum in f32; F.layer_norm on bf16 copies), with its byte bound."""
    import torch.nn.functional as F

    from artgraph_tpu_torch.ops import attention as A

    rng = np.random.default_rng(SEED + 91)
    M, bf = B * N, torch.bfloat16
    dev = lambda a, dt=torch.float32: torch.from_numpy(
        np.asarray(a, np.float32)).to("cuda", dt)
    x = dev(0.5 + 2.0 * rng.normal(size=(M, C)), bf)
    gamma = dev(1.0 + 0.1 * rng.normal(size=C))
    beta = dev(0.1 * rng.normal(size=C))
    dy = dev(rng.normal(size=(M, C)))
    dres = dev(rng.normal(size=(M, C)), bf)

    label = f"layernorm_bwd [{M}, {C}]"
    ours, again = (A.layernorm_bwd_cuda(x, gamma, dy, dres, 1e-6)
                   for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(a, g) for a, g in zip(ours, again)):
        raise AssertionError(f"{label} differs from call to call")
    ref = A.ln_bwd_plain(x, gamma, dy, dres, 1e-6)
    _check_output("layernorm_bwd dx", ours[0], ref[0])
    for name, a, r in zip(("dgamma", "dbeta", "db_res"), ours[1:], ref[1:]):
        rel = _rel_l2(a, r)
        print(f"check: {label} {name} f32 vs plain: rel L2 {rel:.4g}; "
              f"bit-identical on repeat", flush=True)
        if not (rel <= GRAD_REL_L2 and torch.isfinite(a).all()):
            raise AssertionError(f"{label} {name}: rel L2 {rel}")
    del ours, again, ref
    # x, do, dx bf16 and dy f32; gamma in, three f32 sums out
    nbytes = M * C * (2 + 2 + 2 + 4) + 4 * C * 4
    copies = _copies(M * C * 8)
    sets = [(x.clone(), dy.clone(), dres.clone()) for _ in range(copies)]
    _, mean, rstd = torch.native_layer_norm(x.float(), [C], gamma, beta, 1e-6)
    f32_sets = [(xs.float(), d, r.float()) for xs, d, r in sets]

    def library(xf, d, rf):
        dx, dg, db = torch.ops.aten.native_layer_norm_backward(
            d, xf, [C], mean, rstd, gamma, beta, [True, True, True])
        return (rf + dx).to(bf), dg, db

    _time_line(label, _rotating(lambda xs, d, r: A.layernorm_bwd_cuda(
        xs, gamma, d, r, 1e-6), sets), _rotating(
            lambda xs, d, r: A.ln_bwd_plain(xs, gamma, d, r, 1e-6), sets),
        _rotating(library, f32_sets), nbytes, copies)
    del sets, f32_sets, dy, dres

    for cols in (3 * C, HIDDEN, C):
        label = f"colsum [{M}, {cols}]"
        t = dev(0.1 + rng.normal(size=(M, cols)), bf)
        ours, again = A.colsum_cuda(t), A.colsum_cuda(t)
        torch.cuda.synchronize()
        if not torch.equal(ours, again):
            raise AssertionError(f"{label} differs from call to call")
        rel = _rel_l2(ours, t.float().sum(0))
        print(f"check: {label} f32 vs plain: rel L2 {rel:.4g}; "
              f"bit-identical on repeat", flush=True)
        if not (rel <= GRAD_REL_L2 and torch.isfinite(ours).all()):
            raise AssertionError(f"{label}: rel L2 {rel}")
        copies = _copies(M * cols * 2)
        sets = [(t.clone(),) for _ in range(copies)]
        _time_line(label, _rotating(A.colsum_cuda, sets),
                   _rotating(lambda u: u.to(torch.float32).sum(0), sets),
                   _rotating(lambda u: torch.sum(u, 0, dtype=torch.float32),
                             sets),
                   M * cols * 2 + cols * 4, copies)
        del t, ours, again, sets

    label = f"layernorm forward [{M}, {C}]"
    ours, again = (A.layernorm_cuda(x, gamma, beta, 1e-6) for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(ours, again):
        raise AssertionError(f"{label} differs from call to call")
    _check_output("layernorm forward", ours,
                  A.ln_rows_plain(x, gamma, beta, 1e-6))
    gb, bb = gamma.to(bf), beta.to(bf)
    copies = _copies(M * C * 2)
    sets = [(x.clone(),) for _ in range(copies)]
    _time_line(label, _rotating(
        lambda xs: A.layernorm_cuda(xs, gamma, beta, 1e-6), sets),
        _rotating(lambda xs: A.ln_rows_plain(xs, gamma, beta, 1e-6), sets),
        _rotating(lambda xs: F.layer_norm(xs, (C,), gb, bb, 1e-6), sets),
        2 * M * C * 2 + 2 * C * 4, copies)
    torch.cuda.empty_cache()


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


def _csr_copy(csr, **changes):
    """csr with its own copies of the metadata tensors (and `changes`)."""
    import dataclasses

    return dataclasses.replace(
        csr, row_ptr=csr.row_ptr.clone(), dst_sorted=csr.dst_sorted.clone(),
        counts=csr.counts.clone(), plan=csr.plan.clone(), **changes)


def scalar_normalize_phases() -> None:
    """Phases 3 and 4 for rows 9 and 3 alone, by device time. Row 9, the
    CSR scalar sum (csrc/csr_segment.cu), over E = 1M edges into the 32
    `style` hubs ("hub"), the 100K artworks ("rev") and the 18 `genre` hubs
    ("genre"), as in the hidden convs' backward: f32 against the plain twin
    in f64 at CSR_RTOL, CSR_ATOL, bit-identical on repeat. Row 3, the uint8
    normalize (csrc/normalize.cu) at [B, 224, 224, 3] with the ViT
    statistics. Each timed by _time_line beside its plain version, a
    library call the port never makes (segment_reduce; addcmul on a f32
    copy) and its byte bound, the inputs (the edge array with its CSR, the
    uint8 batch) rotated over copies larger than the L2. Where the port
    picks 4 lanes a chunk (rev), the same CSR is also timed at 32, the
    width it would have taken otherwise."""
    from artgraph_tpu_torch import ops
    from artgraph_tpu_torch.ops import csr_segment as T
    from artgraph_tpu_torch.ops.preprocess import norm_coefficients

    rng = np.random.default_rng(SEED + 92)
    E = GNN_EDGES

    def library(v, csr, lengths):
        return torch.segment_reduce(v, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    for label, S in (("hub", 32), ("rev", GNN_ARTWORKS), ("genre", 18)):
        csr = T._csr_from_sorted(np.sort(rng.integers(0, S, E)), S, "cuda")
        w = torch.from_numpy(rng.random(E).astype(np.float32)).cuda()
        name = f"csr_scalar_segment_sum {label} S={S} [{E}]"
        ours, again = (T.scalar_segment_sum_cuda(w, csr) for _ in range(2))
        torch.cuda.synchronize()
        if not torch.equal(ours, again):
            raise AssertionError(f"{name} differs from call to call")
        max_abs, ratio = _csr_err(ours, T.scalar_segment_sum_plain(
            w.double(), csr))
        print(f"check: {name} f32 vs plain in f64: max abs {max_abs:.4g}, "
              f"worst err/(atol+rtol|ref|) {ratio:.4g}; bit-identical on "
              f"repeat", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"{name} disagrees with its plain twin "
                                 f"beyond rtol={CSR_RTOL}, atol={CSR_ATOL}")
        # None: a port from before the lane groups (tools/compare_trees.py
        # runs this phase on an older tree's port)
        widths = [getattr(csr, "scalar_lanes", None)]
        if widths[0] not in (None, 32):
            widths.append(32)
        for lanes in widths:
            copies = _copies(4 * E + csr.plan.numel() * 4)
            changes = {} if lanes == widths[0] else {"scalar_lanes": lanes}
            sets = [(w.clone(), c, torch.diff(c.row_ptr).long()) for c in
                    (_csr_copy(csr, **changes) for _ in range(copies))]
            _time_line(f"{name}" + (f", {lanes} lanes a chunk" if lanes
                                    else ""),
                       _rotating(lambda v, c, _: T.scalar_segment_sum_cuda(
                           v, c), sets),
                       _rotating(lambda v, c, _: T.scalar_segment_sum_plain(
                           v, c), sets),
                       _rotating(library, sets), 4 * (E + 2 * S + 1), copies)
            del sets
        del csr, w

    images = torch.from_numpy(rng.integers(0, 256, (B, 224, 224, 3),
                                           dtype=np.uint8)).cuda()
    alpha, beta = (torch.tensor(c, device="cuda")
                   for c in norm_coefficients("vit"))
    copies = _copies(images.numel())
    sets = [(images.clone(),) for _ in range(copies)]
    _time_line(f"normalize_images [{B}, 224, 224, 3] vit", _rotating(
        lambda x: ops.normalize_images(x, "vit"), sets), _rotating(
        lambda x: ops.normalize_images_plain(x, "vit"), sets), _rotating(
        lambda x: torch.addcmul(beta, x.to(torch.float32), alpha), sets),
        images.numel() * (1 + 4), copies)
    del sets, images
    torch.cuda.empty_cache()


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

        def lib_bwd_full():
            t = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(torch.bfloat16)
            zz = torch.relu(x * a + b) if pro else x
            dz = torch.matmul(t, wb)
            if pro:
                dz = torch.where(x * a + b > 0, dz, 0.0)
            dzf = dz.float()
            return ((dzf * x.float()).sum(0), dzf.sum(0),
                    torch.matmul(t.t(), zz))

        print(f"time: conv1x1_bn_stats_bwd {label} full-function yardstick "
              f"(dyt, prologue, two torch.matmul, two column sums) "
              f"{_time_ms(lib_bwd_full):.4f} ms", flush=True)
        _print_breakdown(f"conv1x1_bn_stats_bwd {label}",
                         lambda: U.conv1x1_bn_stats_bwd_cuda(
                             x, a, b, w, y, dy, ds1, ds2, pro))
        _print_breakdown(f"conv1x1_bn_stats {label}",
                         lambda: U.conv1x1_bn_stats_cuda(x, a, b, w, pro))
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


def _device_work(fn, calls: int) -> tuple[dict, dict]:
    """Run fn `calls` times under torch.profiler: (work, spans), each
    {name: [device ms per call, launches]} read by category from the
    profiler's chrome trace: work sums the device's kernels, memcpys and
    memsets, spans its user-annotation spans (which cover kernels counted on
    their own)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
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
            total[0] += ev.get("dur", 0.0) / calls / 1e3
            total[1] += 1
    return work, spans


def _print_breakdown(label: str, fn, calls: int = 10) -> float:
    """Each kernel's device time per call of fn, largest first (profiler,
    over `calls` calls after one warm-up); returns the summed device ms."""
    fn()
    torch.cuda.synchronize()
    work, _ = _device_work(fn, calls)
    total = sum(ms for ms, _ in work.values())
    for name, (ms, n) in sorted(work.items(), key=lambda kv: -kv[1][0]):
        print(f"breakdown: {label}: {ms:.4f} ms x{n // calls} {name[:100]}",
              flush=True)
    print(f"breakdown: {label}: device {total:.4f} ms per call in all",
          flush=True)
    return total


def _profile_steps(step, steps: int, step_ms: float,
                   label: str = "train") -> dict:
    """Device time by kernel over `steps` profiled steps, and the device idle
    share against the unprofiled step time. Busy time sums the device's
    kernels, memcpys and memsets, read by category from the profiler's
    chrome trace; the user-annotation spans on the device timeline are left
    out and their time printed beside. Returns {name: [ms per step,
    launches in all]}."""
    work, spans = _device_work(step, steps)
    kernels = sorted(((ms, n // steps, name)
                      for name, (ms, n) in work.items()), reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    if busy <= 0:
        print(f"{label} profile: the profiler saw no device time; idle share "
              "not measured", flush=True)
        return work
    dropped = ", ".join(f"{name} {ms:.3f} ms"
                        for name, (ms, _) in spans.items())
    print(f"{label} profile: device busy {busy:.3f} ms per step (kernels, "
          f"memcpys, memsets) against {step_ms:.3f} ms per unprofiled step: "
          f"idle share {max(0.0, 1 - busy / step_ms):.4f}; user-annotation "
          f"spans left out: {dropped or 'none'}", flush=True)
    for ms, calls, name in kernels[:20]:
        print(f"{label} profile:   {ms:8.3f} ms/step {100 * ms / busy:5.1f}% "
              f"{calls:4d} calls  {name[:110]}", flush=True)
    return work


VIT_STEP_LAUNCHES = {"fused_block_attention": 12, "fused_block_mlp": 12,
                     "fused_block_attention_bwd": 12,
                     "fused_block_mlp_bwd": 12, "normalize_images": 1}


def _train_run(label: str, trainer, batch, per_step: dict,
               recipe: str = "adam(3e-4), dropout 0.4"
               ) -> tuple[dict, float, float | None]:
    """TRAIN_WARMUP + TRAIN_STEPS steps of a model on one host batch through
    the Trainer on cuda, the counters zeroed just before the timed steps:
    `per_step` launches a step of each kernel it names, every other kernel
    0; losses finite and falling; then PROFILED_STEPS profiled steps.
    Returns (the launches of per_step's kernels, img/s, device busy ms a
    step or None)."""
    trainer.model.train()

    def step():
        return trainer.train_step(trainer.to_device(batch))[0]

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
    expect.update({k: n * TRAIN_STEPS for k, n in per_step.items()})
    if counts != expect:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{expect}")
    counts = {k: counts[k] for k in per_step}
    losses = torch.stack(losses).tolist()
    img_s = TRAIN_STEPS * B / seconds
    step_ms = 1e3 * seconds / TRAIN_STEPS
    print(f"{label} bf16, {recipe}, batch {B} on cuda: "
          f"{TRAIN_STEPS} steps in {seconds:.3f} s, {img_s:.1f} img/s, "
          f"{step_ms:.2f} ms/step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated); launches {counts} (every other kernel "
          f"0); losses {[round(v, 4) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses not finite and falling: "
                             f"{losses}")
    work = _profile_steps(step, PROFILED_STEPS, step_ms,
                          label=label.split(":")[0])
    busy = sum(ms for ms, _ in work.values())
    return counts, img_s, busy if busy > 0 else None


def train_phase() -> tuple[dict, dict]:
    """Phase 6: ViT-B/16 training steps through the Trainer on cuda;
    (launches, {"img_s", "busy_ms"}) for phase 19's comparison."""
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
    counts, img_s, busy = _train_run(
        "train: ViTSingleTask(32) ViT-B/16", trainer, batch,
        VIT_STEP_LAUNCHES)
    del trainer, model
    torch.cuda.empty_cache()
    return counts, {"img_s": img_s, "busy_ms": busy}


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


def _load_synth():
    """tests/_make_synth.py, loaded by path (tests/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "_make_synth", REPO / "tests" / "_make_synth.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth


def cli_phase(checkpoints_dir: Path) -> None:
    """Phase 8: cli.train_baseline --architecture vit on cuda."""
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli import train_baseline

    synth = _load_synth()
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


def _gnn_model(graph, dropout: float, axis_name: str | None = None):
    """HeteroSGNN as train_gnn_embeddings builds it (GATConv, hidden 128,
    out 32, 2 layers, sum, BN), seeded weights, on the CPU; with axis_name
    for an edge shard."""
    from artgraph_tpu_torch.models.gnn import HeteroSGNN, feature_dims

    torch.manual_seed(SEED)
    return HeteroSGNN(graph.metadata, feature_dims(graph.node_features),
                      operator="GATConv", hidden_channels=128,
                      out_channels=32, n_layers=2, dropout=dropout,
                      axis_name=axis_name)


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
    work = _profile_steps(step, PROFILED_STEPS, step_ms, label="gnn")
    scalar = {n: v for n, v in work.items() if "csr_scalar" in n}
    print(f"gnn profile: csr_scalar_segment_sum's kernels "
          f"{sum(ms for ms, _ in scalar.values()):.4f} ms/step of device "
          f"time, launches a step: "
          + (", ".join(f"{n // PROFILED_STEPS} {name[:70]}"
                       for name, (_, n) in scalar.items()) or "none"),
          flush=True)
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


def _resnet_train_steps(gate: bool) -> tuple[dict, float, float | None]:
    """TRAIN_WARMUP + TRAIN_STEPS Adam steps of ResnetSingleTask(32) at
    batch 32 on cuda, the fused unit's gate as given; (counts, img/s,
    device busy ms a step or None)."""
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
        work = _profile_steps(step, PROFILED_STEPS,
                              1e3 * seconds / TRAIN_STEPS,
                              label=f"resnet gate {label}")
    busy = sum(ms for ms, _ in work.values())
    del trainer, model
    torch.cuda.empty_cache()
    return counts, img_s, busy if busy > 0 else None


def resnet_train_phase() -> tuple[dict, dict]:
    """Phase 13: ResNet50 training with the fused unit, then without;
    (launches, {"img_s", "busy_ms"} of the gate-on run) for phase 21's
    comparison."""
    counts, on, busy = _resnet_train_steps(gate=True)
    _, off, _ = _resnet_train_steps(gate=False)
    print(f"resnet train: gate on {on:.1f} img/s against gate off {off:.1f} "
          f"img/s ({on / off:.4f}x)", flush=True)
    return counts, {"img_s": on, "busy_ms": busy}


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


def _resnet_step(src, build, loss_of, device: str, dtype: torch.dtype,
                 gate: bool, images, held: dict | None = None) -> dict:
    """One train-mode forward and backward of a copy of `src`, build(dtype)
    with dropout 0, on `device` in `dtype` with the fused unit's gate as
    given. loss_of(outputs, device) -> (loss, {name: output tensor}).
    Returns the loss, those outputs, the trunk (`resnet.*`) and head (the
    rest) gradients and the BN statistics' updates, in f64 on the CPU; and
    the unit's launches. With `held`, each launch of the unit is held
    against its plain twin (_units_held_to_plain)."""
    from artgraph_tpu_torch.ops import normalize_images

    before = {n: b.double().clone() for n, b in src.named_buffers()
              if "running" in n}
    model = build(dtype)
    model.load_state_dict(src.state_dict())
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    model = model.to(device).train()
    _zero_counts()
    check = (_units_held_to_plain(held) if held is not None
             else contextlib.nullcontext())
    with _conv_bn_gate(gate), check:
        loss, outputs = loss_of(
            model(normalize_images(images.to(device), "resnet")), device)
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    if any(g is None or not torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError(f"resnet grads: a parameter on {device} has no "
                             f"finite gradient")
    cat = lambda trunk: torch.cat([g.to("cpu", torch.float64).flatten()
                                   for n, g in grads.items()
                                   if n.startswith("resnet.") == trunk])
    return {"loss": loss.detach().double().cpu().reshape(1),
            **{k: v.detach().double().cpu() for k, v in outputs.items()},
            "trunk gradient": cat(True),
            "head gradient": cat(False),
            "BN statistics' updates": _bn_updates(model, before),
            "units": _read_counts(_conv_bn_counters)}


def _hold_step(label: str, src, build, loss_of, images, n_img: int,
               quantities: tuple) -> None:
    """One step of src's weights on n_img images: the unit in bf16 on the
    card, each of its 32 + 32 launches held against the plain twin on its
    own inputs, against the unfused f32 path on the CPU; each quantity at
    relative L2 <= max(TRAIN_GRAD_REL_L2, BF16_FLOOR_FACTOR x the unfused
    bf16 CPU path's own distance from the f32 one) (resnet_grad_phase)."""
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    held: dict = {}
    card = _resnet_step(src, build, loss_of, "cuda", torch.bfloat16, True,
                        images, held)
    ref = _resnet_step(src, build, loss_of, "cpu", torch.float32, False,
                       images)
    floor = _resnet_step(src, build, loss_of, "cpu", torch.bfloat16, False,
                         images)
    calls = (held.get("forward calls"), held.get("backward calls"))
    if card["units"] != dict.fromkeys(card["units"], RESNET_UNITS) or \
            calls != (RESNET_UNITS, RESNET_UNITS):
        raise AssertionError(f"{label}: unit launches {card['units']}, "
                             f"held to the plain twin {held}, expected "
                             f"{RESNET_UNITS} each")
    print(f"{label}: the step's unit launches, each against its plain "
          f"twin on its own inputs on the card (y, dx: worst err/(atol+rtol"
          f"|ref|) at rtol {KERNEL_TOL}, atol {KERNEL_TOL} x mean|ref|, "
          f"limit 1; s1, s2, dw, da, db: worst rel L2, limit {GRAD_REL_L2}; "
          f"da, db without the prologue exactly 0): "
          f"{ {k: round(v, 6) for k, v in held.items()} }", flush=True)
    parts = []
    for q in quantities:
        got, base = rel(card[q], ref[q]), rel(floor[q], ref[q])
        bound = max(TRAIN_GRAD_REL_L2, BF16_FLOOR_FACTOR * base)
        parts.append(f"{q} {got:.4g} (unfused bf16 on the CPU {base:.4g}, "
                     f"bound {bound:.4g})")
        if not got <= bound:
            raise AssertionError(f"{label}: {q} rel L2 {got} > {bound}")
    print(f"{label}: one step on {n_img} images, ResNet50, the unit in "
          f"bf16 on cuda ({card['units']}) vs unfused f32 on the CPU, rel "
          f"L2: {'; '.join(parts)}", flush=True)


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

    def loss_of(logits, device):
        return (cross_entropy(logits, labels.to(device)),
                {"logits": logits})

    _hold_step("resnet grads", src,
               lambda dt: ResnetSingleTask(32, dropout=0.0, dtype=dt),
               loss_of, images, n_img,
               ("loss", "logits", "head gradient", "trunk gradient",
                "BN statistics' updates"))

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

    synth = _load_synth()
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
    counts, _, _ = _train_run(
        "vit unfused train: ViTSingleTask(32) with ViT(fuse_qkv=False),",
        trainer, batch, {"fused_attention": 12, "fused_attention_bwd": 12,
                         "normalize_images": 1})
    del trainer, model
    torch.cuda.empty_cache()
    grad_phase(unfused=True)
    return counts


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


def _fusion_batch(rng, n: int) -> tuple:
    """A host batch of the fusion trainer: (uint8 images, f32 style and genre
    embeddings, labels [n, 2], mask), from rng."""
    from artgraph_tpu_torch import config

    return (rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
            rng.normal(size=(n, config.EMB_SIZE)).astype(np.float32),
            rng.normal(size=(n, config.EMB_SIZE)).astype(np.float32),
            np.stack([rng.integers(0, config.NUM_CLASSES["style"], n),
                      rng.integers(0, config.NUM_CLASSES["genre"], n)], 1)
            .astype(np.int32),
            np.ones(n, np.float32))


def _fusion_grad_check(src) -> None:
    """Phase 19's gradient check: one step of src's weights on 4 images at
    dropout 0, bf16 kernels on cuda against the f32 plain path on the CPU:
    the loss, both heads' logits, each head's gradient and the trunk
    gradient at relative L2 <= TRAIN_GRAD_REL_L2; each block's K third of
    db_qkv (zero in exact arithmetic) by absolute error (_k_third)."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli._common import multi_task_loss
    from artgraph_tpu_torch.models import NewMultiModalMultiTaskViT
    from artgraph_tpu_torch.ops import normalize_images

    batch = _fusion_batch(np.random.default_rng(SEED + 91), 4)
    runs = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = NewMultiModalMultiTaskViT(config.EMB_SIZE,
                                          config.NUM_CLASSES, dropout=0.0,
                                          dtype=dtype)
        model.load_state_dict(src.state_dict())
        model = model.to(device).train()
        img, emb_s, emb_g, labels, mask = (torch.from_numpy(b).to(device)
                                           for b in batch)
        logits = model(normalize_images(img, "vit"), emb_s, emb_g)
        loss, _ = multi_task_loss(None, None, 0.5, 0.5)(
            logits, (img, emb_s, emb_g, labels, mask))
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if not n.startswith("vit.head.")}
        if any(g is None or not torch.isfinite(g).all()
               for g in grads.values()):
            raise AssertionError(f"multimodal grads: a parameter on {device} "
                                 f"has no finite gradient")
        runs[device] = {
            "loss": loss.detach().reshape(1),
            "style logits": logits[0].detach(),
            "genre logits": logits[1].detach(),
            **{n: g for n, g in grads.items()}}
    f64 = {d: {k: v.to("cpu", torch.float64) for k, v in r.items()}
           for d, r in runs.items()}
    ours, ref = f64["cuda"], f64["cpu"]
    k_worst = 0.0
    for name in [n for n in ref if n.endswith("attn.qkv.bias")]:
        k_err, ours[name], ref[name] = _k_third(f"multimodal {name}",
                                                ours[name], ref[name])
        k_worst = max(k_worst, k_err)
    groups = {k: [k] for k in ("loss", "style logits", "genre logits")}
    for head in ("class_style", "class_genre"):
        groups[head] = [n for n in ref if n.startswith(head)]
    groups["trunk"] = [n for n in ref if n.startswith("vit.")]
    cat = lambda d, ns: torch.cat([d[n].flatten() for n in ns])
    rels = {g: ((cat(ours, ns) - cat(ref, ns)).norm()
                / cat(ref, ns).norm()).item() for g, ns in groups.items()}
    print(f"multimodal grads: one step on 4 images (dropout 0), bf16 kernels "
          f"on cuda vs f32 plain on the CPU, rel L2: "
          f"{', '.join(f'{g} {r:.4g}' for g, r in rels.items())} (bound "
          f"{TRAIN_GRAD_REL_L2}; {len(groups['trunk'])} trunk tensors); "
          f"worst db_qkv K third max abs {k_worst:.4g}", flush=True)
    if not all(r <= TRAIN_GRAD_REL_L2 for r in rels.values()):
        raise AssertionError(f"multimodal grads: {rels} beyond "
                             f"{TRAIN_GRAD_REL_L2}")


def multimodal_train_phase(vit_train: dict) -> dict:
    """Phase 19: the reference's best model, NewMultiModalMultiTaskViT at
    full ViT-B/16 width, trained through the Trainer with forward_inputs
    (the images and both embeddings) and the 0.5/0.5 multi-task loss, as
    train_new_multimodal_multitask does; its img/s and device ms a step
    beside phase 6's (vit_train); then the one-step gradient check."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli._common import multi_task_loss
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.models import (NewMultiModalMultiTaskViT,
                                           init_random_)
    from artgraph_tpu_torch.train import Trainer, adam

    src = init_random_(
        NewMultiModalMultiTaskViT(config.EMB_SIZE, config.NUM_CLASSES,
                                  dropout=0.4),
        torch.Generator().manual_seed(SEED + 90))
    model = NewMultiModalMultiTaskViT(config.EMB_SIZE, config.NUM_CLASSES,
                                      dropout=0.4)
    model.load_state_dict(src.state_dict())
    trainer = Trainer(model, adam(3e-4),
                      multi_task_loss(None, None, 0.5, 0.5, "cuda"),
                      transform_type="vit", device="cuda",
                      forward_inputs=image_and_embeddings)
    batch = _fusion_batch(np.random.default_rng(SEED + 90), B)
    counts, img_s, busy = _train_run(
        "multimodal train: NewMultiModalMultiTaskViT(128, style 32, genre "
        "18) ViT-B/16,", trainer, batch, VIT_STEP_LAUNCHES)
    del trainer, model
    torch.cuda.empty_cache()
    fmt = lambda ms: "not measured" if ms is None else f"{ms:.3f} ms"
    ratio = (f"{busy / vit_train['busy_ms']:.4f}x" if busy and
             vit_train["busy_ms"] else "not measured")
    print(f"multimodal train: against phase 6 in this run: {img_s:.1f} "
          f"against {vit_train['img_s']:.1f} img/s; device busy "
          f"{fmt(busy)} against {fmt(vit_train['busy_ms'])} a step "
          f"({ratio})", flush=True)
    _fusion_grad_check(src)
    return counts


def _run_cli(label: str, main, argv: list, phase: str = "pipeline cli"
             ) -> tuple:
    """Run a CLI's main(argv) with the counters zeroed, its prints echoed
    under phase and label; (its return value, its output, every kernel's
    launches)."""
    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    seconds = time.perf_counter() - t0
    counts = {**_all_counts(), **_read_counts(_csr_counters)}
    text = out.getvalue()
    for line in text.splitlines():
        print(f"{phase}: {label}: {line}")
    print(f"{phase}: {label}: {seconds:.1f} s, launches "
          f"{ {k: n for k, n in counts.items() if n} }", flush=True)
    return ret, text, counts


def _expect_launches(label: str, counts: dict, expect: dict,
                     phase: str = "pipeline cli") -> None:
    want = dict.fromkeys(counts, 0)
    want.update(expect)
    if counts != want:
        raise AssertionError(f"{phase}: {label}: launches {counts}, "
                             f"expected {want}")


def _expect_lines(label: str, text: str, *wants: str,
                  phase: str = "pipeline cli") -> None:
    for want in wants:
        if want not in text:
            raise AssertionError(f"{phase}: {label}: no line with "
                                 f"{want!r}")


def pipeline_cli_phase() -> dict:
    """Phase 20: the four pipeline stages through the port's CLIs on cuda,
    at full model width, on a synthetic image tree and KG; returns every
    kernel's launches over the five runs."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli import (generate_projections,
                                        train_gnn_embeddings,
                                        train_new_multimodal,
                                        train_new_multimodal_multitask,
                                        train_projector)
    from artgraph_tpu_torch.cli.predict import infer
    from artgraph_tpu_torch.data.embeddings import (load_embedding,
                                                    save_embedding)
    from artgraph_tpu_torch.data.factories import split_indices
    from artgraph_tpu_torch.data.manifest import prepare_raw_dataset
    from artgraph_tpu_torch.data.transforms import decode_resize_uint8

    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    batch = 8
    blocks = lambda fwd, bwd: {"fused_block_attention": 12 * fwd,
                               "fused_block_mlp": 12 * fwd,
                               "fused_block_attention_bwd": 12 * bwd,
                               "fused_block_mlp_bwd": 12 * bwd}
    nb = lambda n: -(-n // batch)          # batches of n rows
    saved = {k: getattr(config, k) for k in (
        "DATASET_DIR", "IMAGE_DIR", "EMBEDDINGS_DIR", "PROJECTIONS_DIR")}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        counts = _load_synth().make_image_tree(root)
        kg = _write_kg(root / "kg", SEED + 60)
        ds, img = str(root / "dataset"), str(root / "images")
        data = ["--dataset_path", ds, "--image_path", img, "--device", "cuda",
                "--num_workers", "4", "--batch", str(batch), "--epochs", "1"]
        config.EMBEDDINGS_DIR = os.path.join(ds, "train", "embeddings")
        config.PROJECTIONS_DIR = str(root / "proj")
        config.IMAGE_DIR = img
        try:
            # 1. KG embeddings, the train table tiled to the image rows
            config.DATASET_DIR = str(root / "kg")
            _, text, c = _run_cli(
                "1 train_gnn_embeddings", train_gnn_embeddings.main,
                ["--device", "cuda", "--epochs", "3", "--label", "style"])
            add(c)
            _expect_lines("1", text, "style_test_accuracy", "Saved.")
            if not (c["csr_attention_aggregate"] and c["csr_segment_sum"]
                    and c["csr_scalar_segment_sum"]):
                raise AssertionError(f"pipeline cli: 1: CSR launches {c}")
            emb = load_embedding(os.path.join(
                config.EMBEDDINGS_DIR, "test_gnn_artwork_style_embs.pt"))
            if emb.shape != (kg["artwork"], 128):
                raise AssertionError(f"pipeline cli: 1: embeddings "
                                     f"{emb.shape}")
            table = np.resize(emb, (counts["train"], emb.shape[1]))
            for name in ("gnn_style_embs_graph.pt", "gnn_genre_embs_graph.pt"):
                save_embedding(os.path.join(config.EMBEDDINGS_DIR, name),
                               table)
            config.DATASET_DIR = ds

            # 2. the ResNet50 projector, the unit on its full batches
            seed = config.PROJECTION_SPLIT_SEED
            n_train, n_drop = (len(i) for i in
                               split_indices(counts["train"], 0.2, seed))
            n_valid, n_test = (len(i) for i in
                               split_indices(n_drop, 0.5, seed))
            proj_args = ["--node_embedding", "gnn_style_embs_graph.pt",
                         "--emb_type", "artwork"]
            with _conv_bn_gate(True):
                loss, text, c = _run_cli(
                    "2 train_projector", train_projector.main,
                    data + ["--exp", "smoke", *proj_args])
            add(c)
            _expect_lines("2", text, "Train loss: ", "Validation loss: ",
                          f"Test loss: {loss}")
            full = n_train // batch
            _expect_launches("2", c, {
                "conv1x1_bn_stats": RESNET_UNITS * full,
                "conv1x1_bn_stats_bwd": RESNET_UNITS * full,
                "normalize_images": nb(n_train) + nb(n_valid) + nb(n_test)})
            ckpt = root / "proj" / "smoke_checkpoint_projector.pt"
            projector = load_reference_checkpoint("LabelProjector", str(ckpt),
                                                  "cuda")

            # 2b. the ViT projector, into a directory of its own
            config.PROJECTIONS_DIR = str(root / "proj_vit")
            loss, text, c = _run_cli(
                "2b train_projector --architecture vit", train_projector.main,
                data + ["--exp", "smoke_vit", "--architecture", "vit",
                        *proj_args])
            add(c)
            config.PROJECTIONS_DIR = str(root / "proj")
            _expect_lines("2b", text, f"Test loss: {loss}")
            evals = nb(n_valid) + nb(n_test)
            _expect_launches("2b", c, {
                **blocks(nb(n_train) + evals, nb(n_train)),
                "normalize_images": nb(n_train) + evals})
            load_reference_checkpoint(
                "LabelProjectorVit",
                str(root / "proj_vit" / "smoke_vit_checkpoint_projector.pt"),
                "cuda")

            # 3. projections of valid and test, the ResNet projector only
            _, text, c = _run_cli("3 generate_projections",
                                  generate_projections.main,
                                  ["--device", "cuda"])
            add(c)
            _expect_lines("3", text, "Generating projections for validation",
                          "Generating projections for test")
            _expect_launches("3", c, {"normalize_images": 2})
            worst = 0.0
            for split in ("validation", "test"):
                proj = load_embedding(os.path.join(ds, split, "embeddings",
                                                   ckpt.name))
                names = prepare_raw_dataset(ds, split)["image"]
                if proj.shape != (counts[split], 128) or \
                        not np.isfinite(proj).all():
                    raise AssertionError(f"pipeline cli: 3: {split} "
                                         f"{proj.shape}")
                images = torch.from_numpy(np.stack([
                    decode_resize_uint8(os.path.join(img, n))
                    for n in names])).cuda()
                with torch.inference_mode():
                    direct = infer(projector, images,
                                   transform_type="resnet").cpu().double()
                ref = torch.from_numpy(proj).double()
                worst = max(worst, ((ref - direct).norm()
                                    / direct.norm()).item())
            print(f"pipeline cli: 3: the projection files are row-aligned "
                  f"[N, 128], rel L2 {worst:.4g} from a direct forward of "
                  f"the reloaded projector (bound {E2E_REL_L2})", flush=True)
            if not worst <= E2E_REL_L2:
                raise AssertionError(f"pipeline cli: 3: rel L2 {worst}")

            # 4. the best model on the true and projected embeddings
            files = []
            for task in ("style", "genre"):
                files += [f"--emb_train_{task}", f"gnn_{task}_embs_graph.pt",
                          f"--emb_valid_{task}", ckpt.name,
                          f"--emb_test_{task}", ckpt.name]
            results = root / "results"
            (style_acc, genre_acc), text, c = _run_cli(
                "4 train_new_multimodal_multitask",
                train_new_multimodal_multitask.main,
                data + ["--architecture", "vit", "--emb_type", "artwork",
                        "--results_dir", str(results), *files])
            add(c)
            _expect_lines("4", text, "Train loss: ", "Validation loss: ",
                          f"Test style accuracy: {style_acc}; test genre "
                          f"accuracy: {genre_acc}")
            evals = nb(counts["validation"]) + 2 * nb(counts["test"])
            _expect_launches("4", c, {
                **blocks(nb(counts["train"]) + evals, nb(counts["train"])),
                "normalize_images": nb(counts["train"]) + evals})
            for name in ("results_style.csv", "results_genre.csv"):
                if not (results / name).exists():
                    raise AssertionError(f"pipeline cli: 4: no {name}")
            load_reference_checkpoint(
                "NewMultiModalMultiTaskViT",
                os.path.join(config.CHECKPOINTS_DIR,
                             "new-multimodal_multi-task_checkpoint.pt"),
                "cuda")

            # 5. the single-task fusion model (ResNet50) on the same files
            with _conv_bn_gate(True):
                acc, text, c = _run_cli(
                    "5 train_new_multimodal", train_new_multimodal.main,
                    data + ["--label", "genre", "--emb_type", "artwork",
                            "--emb_train", "gnn_genre_embs_graph.pt",
                            "--emb_valid", ckpt.name,
                            "--emb_test", ckpt.name])
            add(c)
            _expect_lines("5", text, "Train loss: ", "validation accuracy: ",
                          f"Test accuracy: {acc}")
            full = counts["train"] // batch
            _expect_launches("5", c, {
                "conv1x1_bn_stats": RESNET_UNITS * full,
                "conv1x1_bn_stats_bwd": RESNET_UNITS * full,
                "normalize_images": nb(counts["train"])
                + nb(counts["validation"]) + nb(counts["test"])})
            load_reference_checkpoint(
                "NewMultiModalSingleTask",
                os.path.join(config.CHECKPOINTS_DIR,
                             "genre_new-multimodal_single-task_checkpoint.pt"),
                "cuda")
        finally:
            for k, v in saved.items():
                setattr(config, k, v)
    print(f"pipeline cli: the four stages on cuda on {counts} synthetic "
          f"images and a {kg['artwork']}-artwork KG: every checkpoint "
          f"reloaded strict; test accuracy style {style_acc}, genre "
          f"{genre_acc} (multitask), genre {acc} (single task); launches "
          f"{ {k: n for k, n in total.items() if n} }", flush=True)
    return total


RESNET_STEP_LAUNCHES = {"conv1x1_bn_stats": RESNET_UNITS,
                        "conv1x1_bn_stats_bwd": RESNET_UNITS,
                        "normalize_images": 1}


def _context_nets() -> tuple:
    """Phase 21's two context models, each (name, build(dtype), optimizer
    factory, recipe text, the CLI's train loss, its eval loss, labels of
    n rows from rng), as train_baseline_context{,_multitask} build them."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli._common import (joint_loss, logits_loss,
                                                multi_task_loss,
                                                single_task_loss)
    from artgraph_tpu_torch.models import (ContextNetSingleTask,
                                           MultiModalMultiTask)
    from artgraph_tpu_torch.train import adam, mse, sgd_momentum, smooth_l1

    nc = config.NUM_CLASSES
    single = single_task_loss(None, "cuda")
    multi = multi_task_loss(None, None, 0.5, 0.5, "cuda")
    return (
        ("ContextNetSingleTask",
         lambda dt: ContextNetSingleTask(config.EMB_SIZE, nc["genre"],
                                         dtype=dt),
         sgd_momentum(3e-4), "sgd_momentum(3e-4), smooth_l1, lamb 0.9",
         joint_loss(single, smooth_l1, 0.9), logits_loss(single),
         lambda rng, n: rng.integers(0, nc["genre"], n).astype(np.int32)),
        ("MultiModalMultiTask",
         lambda dt: MultiModalMultiTask(config.EMB_SIZE, nc, dtype=dt),
         adam(3e-4), "adam(3e-4), mse, lamb 0.6, head dropout 0.2",
         joint_loss(multi, mse, 0.6), logits_loss(multi),
         lambda rng, n: np.stack([rng.integers(0, nc["style"], n),
                                  rng.integers(0, nc["genre"], n)], 1)
         .astype(np.int32)),
    )


def context_train_phase(resnet_train: dict) -> dict:
    """Phase 21: ContextNetSingleTask and MultiModalMultiTask at full
    ResNet50 size through the Trainer on cuda with the joint loss of their
    CLIs and the fused unit's gate open: 2 warm-up and 8 timed steps (32
    forward and 32 backward unit launches and 1 normalize a step), img/s
    and device ms beside phase 13's gated ResnetSingleTask (resnet_train);
    one step on 4 images (head dropout 0) against the unfused f32 path on
    the CPU at phase 14's bound; one ragged step (no unit launch); the model
    saved as a reference .pt and reloaded strict. Returns the launches of
    the timed steps."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import (load_reference_checkpoint,
                                                  save_reference_checkpoint)
    from artgraph_tpu_torch.train import Trainer

    total: dict = {}
    fmt = lambda ms: "not measured" if ms is None else f"{ms:.3f} ms"
    for i, (name, build, optimizer, recipe, train_loss, eval_loss,
            labels_of) in enumerate(_context_nets()):
        seed = SEED + 100 + 10 * i
        src = _seeded_resnet_(build(torch.bfloat16), seed)
        model = build(torch.bfloat16)
        model.load_state_dict(src.state_dict())
        trainer = Trainer(model, optimizer, train_loss,
                          eval_compute_loss=eval_loss,
                          transform_type="resnet", device="cuda")
        rng = np.random.default_rng(seed)
        batch = (rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8),
                 rng.normal(size=(B, config.EMB_SIZE)).astype(np.float32),
                 labels_of(rng, B), np.ones(B, np.float32))
        with _conv_bn_gate(True):
            counts, img_s, busy = _train_run(
                f"context train: {name} ResNet50,", trainer, batch,
                RESNET_STEP_LAUNCHES, recipe)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        ratio = (f"{busy / resnet_train['busy_ms']:.4f}x" if busy and
                 resnet_train["busy_ms"] else "not measured")
        print(f"context train: {name} against phase 13's ResnetSingleTask "
              f"(gate on) in this run: {img_s:.1f} against "
              f"{resnet_train['img_s']:.1f} img/s; device busy {fmt(busy)} "
              f"against {fmt(resnet_train['busy_ms'])} a step ({ratio})",
              flush=True)
        del trainer, model
        torch.cuda.empty_cache()

        # one step on 4 images, head dropout 0, against f32 on the CPU
        n_img = 4
        one = tuple(b[:n_img] for b in batch)

        def loss_of(outputs, device):
            dev = tuple(torch.from_numpy(np.asarray(b)).to(device)
                        for b in one)
            loss, _ = train_loss(outputs, dev)
            logits, graph_proj = outputs
            named = ({"logits": logits} if torch.is_tensor(logits) else
                     {"style logits": logits[0], "genre logits": logits[1]})
            return loss, {**named, "graph_proj": graph_proj}

        outs = (("logits",) if name.startswith("ContextNet")
                else ("style logits", "genre logits"))
        _hold_step(f"context grads: {name}", src, build, loss_of,
                   torch.from_numpy(one[0]), n_img,
                   ("loss", *outs, "graph_proj", "head gradient",
                    "trunk gradient", "BN statistics' updates"))

        # a ragged step: the unit stays off
        mask = np.zeros(n_img, np.float32)
        mask[:n_img // 2] = 1.0
        model = build(torch.bfloat16)
        model.load_state_dict(src.state_dict())
        trainer = Trainer(model, optimizer, train_loss,
                          transform_type="resnet", device="cuda")
        _zero_counts()
        with _conv_bn_gate(True):
            loss, _ = trainer.train_step(
                trainer.to_device((*one[:3], mask)), ragged=True)
        units = _read_counts(_conv_bn_counters)
        if any(units.values()) or not torch.isfinite(loss):
            raise AssertionError(f"context ragged step: {name}: unit "
                                 f"launches {units}, loss {loss}")
        print(f"context grads: {name}: one ragged step ({n_img // 2} of "
              f"{n_img} rows valid) on cuda, gate open: unit launches "
              f"{units}, loss {loss.item():.4f}", flush=True)

        # the reference .pt: indexed trunk keys for ContextNet, torchvision's
        # names for MultiModal, reloaded strict
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}.pt")
            save_reference_checkpoint(src, path)
            loaded = load_reference_checkpoint(name, path, "cuda")
        sd, got = src.state_dict(), loaded.state_dict()
        key = ("resnet.conv1.weight" if name.startswith("MultiModal")
               else "resnet.0.weight")
        if key not in got or sorted(got) != sorted(sd) or any(
                not torch.equal(got[k].cpu().to(v.dtype), v)
                for k, v in sd.items()):
            raise AssertionError(f"context train: {name}: the reloaded .pt "
                                 f"differs (keys {sorted(got)[:3]})")
        print(f"context train: {name}: reference .pt of {len(got)} tensors "
              f"({key}, ...) reloaded strict on cuda, equal", flush=True)
        del loaded, src
        torch.cuda.empty_cache()
    return total


def baseline_cli_phase() -> dict:
    """Phase 22: train_baseline_multitask (ResNet50 with the unit's gate
    open, and ViT-B/16), train_baseline_context (context-net, multi-modal)
    and train_baseline_context_multitask (multi-modal) on cuda, 1 epoch at
    --batch 10 on a synthetic image tree with a train embedding table
    beside it: each run's lines, every kernel's launches (the unit on the
    full train batches only), its checkpoint reloaded strict and its CSVs.
    Returns every kernel's launches over the five runs."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli import (train_baseline_context,
                                        train_baseline_context_multitask,
                                        train_baseline_multitask)
    from artgraph_tpu_torch.data.embeddings import save_embedding

    total: dict = {}
    batch = 10
    nb = lambda n: -(-n // batch)
    multi = ["Train loss: ", "train style accuracy: ",
             "validation genre accuracy ", "Test style accuracy: "]
    single = ["Train loss: ", "validation accuracy: ", "Test accuracy: "]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        counts = _load_synth().make_image_tree(root)
        ds, img = root / "dataset", root / "images"
        save_embedding(str(ds / "train" / "embeddings" / "emb.pt"),
                       np.random.default_rng(SEED + 120).normal(
                           size=(counts["train"], config.EMB_SIZE))
                       .astype(np.float32))
        full, n_train = counts["train"] // batch, nb(counts["train"])
        if counts["train"] % batch == 0:
            raise AssertionError("baseline cli: the last batch is not ragged")
        units = {"conv1x1_bn_stats": RESNET_UNITS * full,
                 "conv1x1_bn_stats_bwd": RESNET_UNITS * full}
        blocks = lambda fwd, bwd: {"fused_block_attention": 12 * fwd,
                                   "fused_block_mlp": 12 * fwd,
                                   "fused_block_attention_bwd": 12 * bwd,
                                   "fused_block_mlp_bwd": 12 * bwd}
        emb = ["--emb_train", "emb.pt"]
        evals = {1: nb(counts["validation"]) + nb(counts["test"]),
                 2: nb(counts["validation"]) + 2 * nb(counts["test"])}
        runs = (
            ("multitask resnet", train_baseline_multitask.main,
             ["--architecture", "resnet"], multi, "ResnetMultiTask",
             "resnet_baseline_single-task_checkpoint.pt", 2,
             {**units, "normalize_images": n_train + evals[2]}),
            ("multitask vit", train_baseline_multitask.main,
             ["--architecture", "vit"], multi, "ViTMultiTask",
             "vit_baseline_single-task_checkpoint.pt", 2,
             {**blocks(n_train + evals[2], n_train),
              "normalize_images": n_train + evals[2]}),
            ("context context-net", train_baseline_context.main,
             ["--net", "context-net", "--label", "genre", *emb], single,
             "ContextNetSingleTask",
             "genre_context-net_single-task_checkpoint.pt", 1,
             {**units, "normalize_images": n_train + evals[1]}),
            ("context multi-modal", train_baseline_context.main,
             ["--net", "multi-modal", "--label", "style", *emb], single,
             "MultiModalSingleTask",
             "style_multi-modal_single-task_checkpoint.pt", 1,
             {**units, "normalize_images": n_train + evals[1]}),
            ("context multitask multi-modal",
             train_baseline_context_multitask.main,
             ["--net", "multi-modal", *emb], multi, "MultiModalMultiTask",
             "multi-modal_multi-task_checkpoint.pt", 2,
             {**units, "normalize_images": n_train + evals[2]}),
        )
        for label, main, extra, lines, model_name, ckpt, tasks, expect \
                in runs:
            results = root / f"results_{label.replace(' ', '_')}"
            with _conv_bn_gate(True):
                ret, text, c = _run_cli(
                    label, main,
                    ["--dataset_path", str(ds), "--image_path", str(img),
                     "--device", "cuda", "--num_workers", "4", "--epochs",
                     "1", "--batch", str(batch), "--results_dir",
                     str(results), *extra], phase="baseline cli")
            for k, n in c.items():
                total[k] = total.get(k, 0) + n
            _expect_lines(label, text, *lines, phase="baseline cli")
            _expect_launches(label, c, expect, phase="baseline cli")
            accs = ret if isinstance(ret, tuple) else (ret,)
            names = (["results_style.csv", "results_genre.csv"] if tasks == 2
                     else ["results.csv"])
            if len(accs) != tasks or not all(0.0 <= a <= 1.0 for a in accs) \
                    or not all((results / n).exists() for n in names):
                raise AssertionError(
                    f"baseline cli: {label}: accuracies {accs}, CSVs "
                    f"{sorted(os.listdir(results))}")
            model = load_reference_checkpoint(
                model_name, os.path.join(config.CHECKPOINTS_DIR, ckpt),
                "cuda")
            print(f"baseline cli: {label}: {ckpt} reloaded strict as "
                  f"{model_name} ({len(model.state_dict())} tensors); "
                  f"{', '.join(names)} written; test accuracy {accs}",
                  flush=True)
            del model
    print(f"baseline cli: the three trainers on cuda on {counts} synthetic "
          f"images: launches {total}", flush=True)
    return total


# --------------------------------------------------------------------------
# Phases 23-25: the graphed step, the resident epoch, capture safety
# --------------------------------------------------------------------------

GRAPH_FULL_STEPS = 4            # full batches of phase 23's exactness check
GRAPH_WINDOWS, GRAPH_WINDOW_STEPS = 3, 6
GRAPH_REL_L2 = 1e-6             # graphed against eager where not identical
RESIDENT_IMAGES = 1024          # phase 24's resident dataset, 154 MB
# the port's kernels by the name the profiler gives them (csrc/*.cu)
OUR_KERNELS = ("normalize_u8_kernel", "attention_core_kernel",
               "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel",
               "layernorm_rows_kernel", "gemm_kernel", "layernorm_bwd_kernel",
               "colsum_kernel", "unit_gemm_kernel", "sum_groups_kernel",
               "sum_groups_seq_kernel")


def _set_dropout(model: torch.nn.Module, p: float) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = p
    return model


def _graph_specs() -> list:
    """Phase 23's five models as phases 6, 13 (gate on and off), 19 and 21
    train them: (label, make() -> seeded model, optimizer, loss,
    transform, forward_inputs, batch(rng, n) without the mask, gate, the
    kernels' launches a step)."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli._common import (multi_task_loss,
                                                single_task_loss)
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.models import (NewMultiModalMultiTaskViT,
                                           ResnetSingleTask, ViTSingleTask,
                                           init_random_)
    from artgraph_tpu_torch.train import adam
    from artgraph_tpu_torch.train.trainer import image_only

    single = single_task_loss(None, "cuda")
    images_labels = lambda rng, n: (
        rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
        rng.integers(0, 32, n).astype(np.int32))
    ctx_name, ctx_build, ctx_opt, _, ctx_loss, _, ctx_labels = \
        _context_nets()[0]
    resnet = lambda: _seeded_resnet_(ResnetSingleTask(32, dropout=0.4),
                                     SEED + 80)
    return [
        ("ViTSingleTask(32) ViT-B/16 (phase 6)",
         lambda: init_random_(ViTSingleTask(32, dropout=0.4),
                              torch.Generator().manual_seed(SEED + 10)),
         adam(3e-4), single, "vit", image_only, images_labels, False,
         VIT_STEP_LAUNCHES),
        ("ResnetSingleTask(32) ResNet50 gate on (phase 13)", resnet,
         adam(3e-4), single, "resnet", image_only, images_labels, True,
         RESNET_STEP_LAUNCHES),
        ("ResnetSingleTask(32) ResNet50 gate off (phase 13)", resnet,
         adam(3e-4), single, "resnet", image_only, images_labels, False,
         {"normalize_images": 1}),
        ("NewMultiModalMultiTaskViT ViT-B/16 (phase 19)",
         lambda: init_random_(
             NewMultiModalMultiTaskViT(config.EMB_SIZE, config.NUM_CLASSES,
                                       dropout=0.4),
             torch.Generator().manual_seed(SEED + 90)),
         adam(3e-4), multi_task_loss(None, None, 0.5, 0.5, "cuda"), "vit",
         image_and_embeddings, lambda rng, n: _fusion_batch(rng, n)[:-1],
         False, VIT_STEP_LAUNCHES),
        (f"{ctx_name} ResNet50 gate on (phase 21)",
         lambda: _seeded_resnet_(ctx_build(torch.bfloat16), SEED + 100),
         ctx_opt, ctx_loss, "resnet", image_only,
         lambda rng, n: (rng.integers(0, 256, (n, 224, 224, 3),
                                      dtype=np.uint8),
                         rng.normal(size=(n, config.EMB_SIZE))
                         .astype(np.float32), ctx_labels(rng, n)),
         True, RESNET_STEP_LAUNCHES),
    ]


def _spec_trainer(spec, model):
    from artgraph_tpu_torch.train import Trainer

    _, _, opt, loss, transform, inputs, _, _, _ = spec
    return Trainer(model, opt, loss, transform_type=transform, device="cuda",
                   forward_inputs=inputs)


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms inside: a graph and the eager step
    then run the same arithmetic, so they can be held to equality."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _eager_epoch(trainer, batches) -> dict:
    """train_epoch's totals from eager train_step calls on the same
    batches (the synchronous path, with no graph)."""
    trainer.model.train()
    totals, examples = {}, 0.0
    for batch in batches:
        dev = trainer.to_device(batch)
        n = float(batch[-1].sum())
        loss, metrics = trainer.train_step(dev, ragged=n < len(batch[-1]))
        trainer._accumulate(totals, loss, metrics, dev[-1])
        examples += n
    return trainer._read(totals, examples)


def _state_distance(a: torch.nn.Module, b: torch.nn.Module,
                    buffers: bool) -> tuple[float, float]:
    """(max abs, relative L2) between two models' parameters, or their
    BatchNorm running statistics."""
    pick = ((lambda m: [t for n, t in m.named_buffers() if "running" in n])
            if buffers else (lambda m: list(m.parameters())))
    x, y = (torch.cat([t.detach().double().flatten() for t in pick(m)])
            if pick(m) else torch.zeros(1, dtype=torch.float64,
                                        device="cuda") for m in (a, b))
    return ((x - y).abs().max().item(),
            ((x - y).norm() / y.norm().clamp_min(1e-30)).item())


def _trace_events(fn, calls: int = 1) -> list:
    """The profiler's chrome-trace events, host and device, over `calls`
    calls of fn. One more call runs
    first under the profiler and is not counted: on the card a trace can
    miss device events for a while after the profiler starts (up to half a
    ViT step's forward, seen in this script's runs)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "chip_smoke: measured calls"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    start = min(ev["ts"] for ev in events if ev.get("name") == mark)
    return [ev for ev in events if ev.get("ts", -1) >= start]


def _our_kernels(fn, calls: int) -> dict:
    """{our kernel (unit_gemm_kernel by mode): launches per call of fn},
    from the profiler."""
    import re

    out: dict = {}
    for ev in _trace_events(fn, calls):
        if ev.get("cat") != "kernel":
            continue
        for base in OUR_KERNELS:
            if re.search(rf"(?<![\w]){base}(?![\w])", ev["name"]):
                if base == "unit_gemm_kernel":
                    # <0, true>, <(Mode)0, true>, ...: the mode's digits
                    mode = re.search(r"unit_gemm_kernel<[^,>]*?(\d+)\s*,",
                                     ev["name"])
                    base = f"unit_gemm_kernel<{mode.group(1) if mode else '?'}>"
                out[base] = out.get(base, 0) + 1 / calls
                break
    return out


def _memcpy_sources(events: list, calls: int) -> dict:
    """{"outermost op > innermost op": cudaMemcpyAsync calls per call} from
    a trace's host events: each copy call named by the operators that
    enclose it on its thread (the autograd engine's thread for the
    backward's)."""
    ops: dict = {}
    for ev in events:
        if ev.get("cat") == "cpu_op":
            ops.setdefault(ev.get("tid"), []).append(ev)
    out: dict = {}
    for ev in events:
        if ev.get("cat") != "cuda_runtime" or "Memcpy" not in ev["name"]:
            continue
        around = sorted((o for o in ops.get(ev.get("tid"), ())
                         if o["ts"] <= ev["ts"] <= o["ts"] + o["dur"]),
                        key=lambda o: (o["ts"], -o["dur"]))
        key = (" > ".join(dict.fromkeys((around[0]["name"],
                                         around[-1]["name"])))
               if around else "(no operator)")
        out[key] = out.get(key, 0) + 1 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _counters_as_kernels(counts: dict) -> dict:
    """The kernels that each counted wrapper launch runs a known number of
    times (csrc/*.cu): the normalize kernel once per normalize; the
    attention core once per block-attention forward and once more in its
    backward's recompute; dK/dV once per backward; the LayerNorm backward
    once per block-attention and block-MLP backward; the unit's forward
    product (mode 0) once per unit forward, its weight-gradient product
    (mode 2) once per unit backward."""
    get = lambda mod, attr: counts.get(
        (f"artgraph_tpu_torch.ops.{mod}", attr), 0)
    attn_f, attn_b = get("attention", "LAUNCHES"), get("attention",
                                                       "LAUNCHES_BWD")
    want = {"normalize_u8_kernel": get("preprocess", "LAUNCHES"),
            "attention_core_kernel": attn_f + attn_b,
            "attention_bwd_dkv_kernel": attn_b,
            "layernorm_bwd_kernel": attn_b + get("mlp", "LAUNCHES_BWD"),
            "unit_gemm_kernel<0>": get("conv_bn", "LAUNCHES"),
            "unit_gemm_kernel<2>": get("conv_bn", "LAUNCHES_BWD")}
    return {k: v for k, v in want.items() if v}


def _graph_exact(spec) -> None:
    """Phase 23 at dropout 0: GRAPH_FULL_STEPS full batches and a ragged
    one through train_epoch (the first batch the eager warm-up, then
    replays; a BatchNorm model's ragged batch eager under its mask) against
    eager train_step on the same batches from the same weights; then each
    counter per replay against the profiler's kernel counts."""
    import copy

    from artgraph_tpu_torch.ops import launches

    label, make, *_, batch_of, gate, per_step = spec
    rng = np.random.default_rng(SEED + 130)
    batches = []
    for i in range(GRAPH_FULL_STEPS + 1):
        mask = np.ones(B, np.float32)
        if i == GRAPH_FULL_STEPS:
            mask[B // 2 + 3:] = 0.0
        batches.append((*batch_of(rng, B), mask))
    src = _set_dropout(make(), 0.0)
    graphed = _spec_trainer(spec, copy.deepcopy(src))
    eager = _spec_trainer(spec, src)
    with _conv_bn_gate(gate), _deterministic():
        got = [graphed.train_epoch([b])["loss"] for b in batches]
        want = [_eager_epoch(eager, [b])["loss"] for b in batches]
        torch.cuda.synchronize()
        loss_err = max(abs(a - b) for a, b in zip(got, want))
        p_abs, p_rel = _state_distance(graphed.model, eager.model, False)
        b_abs, b_rel = _state_distance(graphed.model, eager.model, True)
        same = loss_err == 0 and p_abs == 0 and b_abs == 0
        print(f"graph exact: {label}, dropout 0, {GRAPH_FULL_STEPS} full "
              f"batches + 1 ragged through train_epoch (graphs "
              f"{len(graphed.graphs)}) against eager train_step from the "
              f"same weights: per-step losses max |diff| {loss_err:.3g}; "
              f"parameters max |diff| {p_abs:.3g}, rel L2 {p_rel:.3g}; BN "
              f"buffers max |diff| {b_abs:.3g}, rel L2 {b_rel:.3g}: "
              + ("bit-identical" if same else
                 f"not identical, held at rel L2 <= {GRAPH_REL_L2}"),
              flush=True)
        if len(graphed.graphs) != 1 or not (
                same or (p_rel <= GRAPH_REL_L2 and b_rel <= GRAPH_REL_L2
                         and loss_err <= GRAPH_REL_L2 * max(map(abs,
                                                                want)))):
            raise AssertionError(f"graph exact: {label}: the graphed steps "
                                 f"differ from the eager ones")
        # the counters per replay against the profiler's kernel counts
        calls = 2
        before = launches.snapshot()
        seen = _our_kernels(lambda: graphed.train_epoch([batches[0]]),
                            calls)
        counted = launches.since(before)
        seen_eager = _our_kernels(
            lambda: eager.train_step(eager.to_device(batches[0])), calls)
    # _our_kernels runs fn once more before the profiled calls
    counted = {k: n / (calls + 1) for k, n in counted.items()}
    expect = _counters_as_kernels(counted)
    per_replay = {k: counted.get((mod.__name__, attr), 0) for k, (mod, attr)
                  in {**_counters(), **_conv_bn_counters()}.items()}
    per_replay = {k: v for k, v in per_replay.items() if v}
    print(f"graph counts: {label}: counters per replay {per_replay}; the "
          f"profiler's kernels per replay {seen}; per eager step "
          f"{seen_eager}", flush=True)
    if per_replay != {k: float(v) for k, v in per_step.items()}:
        raise AssertionError(f"graph counts: {label}: counters per replay "
                             f"{per_replay}, expected {per_step}")
    if not seen or seen != seen_eager or any(
            seen.get(k) != v for k, v in expect.items()):
        raise AssertionError(f"graph counts: {label}: the profiler's "
                             f"kernels per replay {seen} (eager "
                             f"{seen_eager}) do not match the counters "
                             f"({expect})")
    del graphed, eager, src
    torch.cuda.empty_cache()


def _graph_turns(spec) -> dict:
    """Phase 23 at the phases' own dropout: graphed (train_epoch over
    GRAPH_WINDOW_STEPS copies of one host batch: prefetch, replays) against
    eager (train_step on the same batch) in turns, GRAPH_WINDOWS windows
    each, medians; device busy ms a step and the memcpy calls by the
    profiler; each trainer's peak allocated and held memory."""
    import copy

    label, make, *_, batch_of, gate, _ = spec
    batch = (*batch_of(np.random.default_rng(SEED + 131), B),
             np.ones(B, np.float32))
    src = make()
    trainers, peak, held = {}, {}, {}
    with _conv_bn_gate(gate):
        # each trainer's memory above what was there before it: the peak
        # allocated over its warm-up (and capture: a replay allocates
        # nothing), and what it holds after, graph pool included
        for mode in ("eager", "graphed"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            base_reserved = torch.cuda.memory_reserved()
            trainer = trainers[mode] = _spec_trainer(spec,
                                                     copy.deepcopy(src))
            if mode == "eager":
                for _ in range(2):
                    trainer.train_step(trainer.to_device(batch))
            else:
                trainer.train_epoch([batch] * 2)
            torch.cuda.synchronize()
            peak[mode] = (torch.cuda.max_memory_allocated() - base) / 1e9
            torch.cuda.empty_cache()
            held[mode] = (torch.cuda.memory_reserved() - base_reserved) / 1e9
        graphed, eager = trainers["graphed"], trainers["eager"]
        modes = {
            "eager": (eager, lambda: [
                eager.train_step(eager.to_device(batch))
                for _ in range(GRAPH_WINDOW_STEPS)]),
            "graphed": (graphed, lambda: graphed.train_epoch(
                [batch] * GRAPH_WINDOW_STEPS)),
        }
        ms = {k: [] for k in modes}
        for _ in range(GRAPH_WINDOWS):
            for mode, (_, run) in modes.items():
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                ms[mode].append(1e3 * (time.perf_counter() - t0)
                                / GRAPH_WINDOW_STEPS)
        busy, sources = {}, {}
        for mode, (trainer, _) in modes.items():
            step = ((lambda: trainer.train_step(trainer.to_device(batch)))
                    if mode == "eager"
                    else (lambda: trainer.train_epoch([batch])))
            events = _trace_events(step, PROFILED_STEPS)
            busy[mode] = sum(ev.get("dur", 0.0) for ev in events
                             if ev.get("cat") in DEVICE_WORK
                             ) / PROFILED_STEPS / 1e3
            sources[mode] = _memcpy_sources(events, PROFILED_STEPS)
    out = {}
    for mode in modes:
        step_ms = float(np.median(ms[mode]))
        out[mode] = {"ms": step_ms, "img_s": 1e3 * B / step_ms,
                     "busy_ms": busy[mode],
                     "idle": max(0.0, 1 - busy[mode] / step_ms)
                     if busy[mode] > 0 else None, "peak_gb": peak[mode],
                     "held_gb": held[mode]}
    fmt = lambda m: (f"{m['ms']:.3f} ms/step, {m['img_s']:.1f} img/s, "
                     f"device busy {m['busy_ms']:.3f} ms, idle share "
                     + ("not measured" if m["idle"] is None
                        else f"{m['idle']:.4f}")
                     + f", peak allocated {m['peak_gb']:.3f} GB, held "
                       f"{m['held_gb']:.3f} GB")
    print(f"graph turns: {label}, batch {B}, in turns ({GRAPH_WINDOWS} "
          f"windows of {GRAPH_WINDOW_STEPS} steps each way, medians): eager "
          f"{fmt(out['eager'])} | graphed {fmt(out['graphed'])} | "
          f"graphed/eager img/s {out['graphed']['img_s'] / out['eager']['img_s']:.4f}x, "
          f"busy {out['graphed']['busy_ms'] / max(out['eager']['busy_ms'], 1e-9):.4f}x "
          f"(memory: each trainer's own, above what was allocated before "
          f"it; held: reserved after its steps, the graph's pool "
          f"included)", flush=True)
    for mode, found in sources.items():
        print(f"graph memcpy: {label}, {mode}: cudaMemcpyAsync calls a step "
              f"by the operators around them (outermost > innermost): "
              f"{found}", flush=True)
    del graphed, eager, trainer, trainers, modes, src
    torch.cuda.empty_cache()
    return out


def graph_train_phase() -> dict:
    """Phase 23: the graphed step of five models against their eager step:
    equal at dropout 0, the counters per replay equal to the profiler's
    kernel counts, then timed in turns."""
    turns = {}
    for spec in _graph_specs():
        _graph_exact(spec)
        turns[spec[0]] = _graph_turns(spec)
    return turns


class _Rows:
    """n seeded rows of (uint8 224 px image, int32 label)."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
        self.labels = rng.integers(0, 32, n).astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        return self.images[idx], self.labels[idx]


def _h2d(fn) -> list:
    """The bytes of each host-to-device copy while fn runs, from the
    profiler's memcpy events."""
    return [int(ev.get("args", {}).get("bytes", 0))
            for ev in _trace_events(fn)
            if ev.get("cat") == "gpu_memcpy" and "HtoD" in ev.get("name", "")]


def resident_phase() -> dict:
    """Phase 24: RESIDENT_IMAGES seeded 224 px images held on the card; the
    ResidentLoader's batches against the host loader's; ResNet50 (gate on)
    and ViT-B/16 at dropout 0, an epoch each three ways (the epoch from the
    index and mask matrices, the per-batch device stream, the host loader
    with prefetch), losses equal, seconds and img/s, the profiler's H2D
    bytes; then train_baseline with --resident_data, with --resident_data
    --no_epoch_scan and with --image_cache, both architectures. Returns
    the CLI runs' launches."""
    import copy

    from artgraph_tpu_torch.data.loader import DataLoader
    from artgraph_tpu_torch.data.resident import ResidentLoader

    rows = _Rows(RESIDENT_IMAGES, SEED + 140)
    t0 = time.perf_counter()
    resident = ResidentLoader(rows, B, shuffle=True, seed=SEED,
                              device="cuda")
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    host = DataLoader(rows, B, shuffle=True, seed=SEED, num_workers=4)
    nb = 0
    for r, h in zip(resident, host):
        k = int(h[-1].sum())
        if not (np.array_equal(r[-1], h[-1]) and all(
                torch.equal(a[:k], torch.from_numpy(b[:k]).cuda())
                for a, b in zip(r[:-1], h[:-1]))):
            raise AssertionError(f"resident: batch {nb} differs from the "
                                 f"host loader's")
        nb += 1
    if nb != len(host):
        raise AssertionError(f"resident: {nb} batches, host {len(host)}")
    print(f"resident: {RESIDENT_IMAGES} images of 224 px uint8 "
          f"({resident.nbytes / 1e6:.1f} MB with the labels) uploaded in "
          f"{upload:.3f} s; an epoch of {nb} shuffled batches equal to the "
          f"host loader's (valid rows and masks)", flush=True)
    del resident
    specs = {s[0]: s for s in _graph_specs()}
    idx_mask_bytes = nb * B * (8 + 4)
    for key in ("ResnetSingleTask(32) ResNet50 gate on (phase 13)",
                "ViTSingleTask(32) ViT-B/16 (phase 6)"):
        spec = specs[key]
        src = _set_dropout(spec[1](), 0.0)
        losses = {}
        for way in ("epoch arrays", "device_iter", "host + prefetch"):
            loader = (DataLoader(rows, B, shuffle=True, seed=SEED,
                                 num_workers=4) if way == "host + prefetch"
                      else ResidentLoader(rows, B, shuffle=True, seed=SEED,
                                          epoch_scan=way == "epoch arrays",
                                          device="cuda"))
            trainer = _spec_trainer(spec, copy.deepcopy(src))
            with _conv_bn_gate(spec[7]), _deterministic():
                first = trainer.train_epoch(loader)["loss"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                second = trainer.train_epoch(loader)["loss"]
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                copies = _h2d(lambda: trainer.train_epoch(loader))
            losses[way] = (first, second)
            print(f"resident epoch: {key}, dropout 0, {way}: epoch losses "
                  f"{first!r}, {second!r}; the second epoch {seconds:.4f} s, "
                  f"{RESIDENT_IMAGES / seconds:.1f} img/s ({nb} steps); a "
                  f"profiled third epoch: {len(copies)} host-to-device "
                  f"copies, {sum(copies)} bytes (largest "
                  f"{max(copies, default=0)})", flush=True)
            # resident: the [nb, B] int64 index and f32 mask matrices only
            # (the profiler may drop an event, never add one); host: every
            # image crosses
            if way == "host + prefetch":
                ok = sum(copies) >= rows.images.nbytes
            else:
                ok = (sum(copies) <= idx_mask_bytes
                      and max(copies, default=0) <= nb * B * 8)
            if not ok:
                raise AssertionError(
                    f"resident epoch: {way}: host-to-device copies of "
                    f"{copies} bytes; expected the index and mask matrices "
                    f"({nb * B * 8} and {nb * B * 4} bytes) on the resident "
                    f"paths, every image on the host one")
            if not np.isfinite([first, second]).all():
                raise AssertionError(f"resident epoch: {way}: losses "
                                     f"{first}, {second}")
            del trainer, loader
            torch.cuda.empty_cache()
        if len(set(losses.values())) != 1:
            raise AssertionError(f"resident epoch: {key}: the three ways' "
                                 f"losses differ: {losses}")
        print(f"resident epoch: {key}: the three ways' epoch losses equal",
              flush=True)
        del src
    return _resident_cli()


def _resident_cli() -> dict:
    """Phase 24's CLI runs: train_baseline --architecture resnet (gate open)
    and vit with --resident_data, --resident_data --no_epoch_scan and
    --image_cache on phase 15's synthetic tree, 1 epoch at --batch 10."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli import train_baseline

    total: dict = {}
    batch = 10
    nbat = lambda n: -(-n // batch)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        counts = _load_synth().make_image_tree(root)
        n_train = nbat(counts["train"])
        evals = nbat(counts["validation"]) + nbat(counts["test"])
        full = counts["train"] // batch
        if counts["train"] % batch == 0:
            raise AssertionError("resident cli: the last batch is not ragged")
        expect = {
            "resnet": {"conv1x1_bn_stats": RESNET_UNITS * full,
                       "conv1x1_bn_stats_bwd": RESNET_UNITS * full,
                       "normalize_images": n_train + evals},
            "vit": {"fused_block_attention": 12 * (n_train + evals),
                    "fused_block_mlp": 12 * (n_train + evals),
                    "fused_block_attention_bwd": 12 * n_train,
                    "fused_block_mlp_bwd": 12 * n_train,
                    "normalize_images": n_train + evals}}
        models = {"resnet": "ResnetSingleTask", "vit": "ViTSingleTask"}
        for arch in ("resnet", "vit"):
            for flags in (["--resident_data"],
                          ["--resident_data", "--no_epoch_scan"],
                          ["--image_cache", str(root / f"cache_{arch}")]):
                label = f"{arch} {' '.join(flags[:2] if flags[0] != '--image_cache' else flags[:1])}"
                with _conv_bn_gate(arch == "resnet"):
                    ret, text, c = _run_cli(
                        label, train_baseline.main,
                        ["--dataset_path", str(root / "dataset"),
                         "--image_path", str(root / "images"),
                         "--architecture", arch, "--label", "style",
                         "--epochs", "1", "--batch", str(batch),
                         "--num_workers", "4", "--device", "cuda", *flags],
                        phase="resident cli")
                for k, n in c.items():
                    total[k] = total.get(k, 0) + n
                _expect_lines(label, text, "Train loss: ",
                              "Validation loss: ", f"Test accuracy: {ret}",
                              phase="resident cli")
                _expect_launches(label, c, expect[arch],
                                 phase="resident cli")
                name = f"style_{arch}_baseline_single-task_checkpoint.pt"
                model = load_reference_checkpoint(
                    models[arch], os.path.join(config.CHECKPOINTS_DIR, name),
                    "cuda")
                note = (f"the unit on the {full} full train batches only"
                        if arch == "resnet" else "the blocks' backward on "
                        "the train batches only")
                print(f"resident cli: {label}: launches as expected "
                      f"({note}); {name} "
                      f"reloaded strict ({len(model.state_dict())} tensors); "
                      f"test accuracy {ret}", flush=True)
                del model
            cache = sorted(os.listdir(root / f"cache_{arch}"))
            print(f"resident cli: {arch} --image_cache wrote {cache}",
                  flush=True)
    return total


def capture_phase() -> None:
    """Phase 25: rows 1, 1b, 2, 2b, 3, 10 and 10b each captured alone in a
    CUDA graph at the main path's shapes, replayed on new inputs copied into
    the static buffers: every output bit-identical to the eager launch on
    those inputs."""
    from artgraph_tpu_torch import ops
    from artgraph_tpu_torch.ops import attention, conv_bn, mlp

    rng = np.random.default_rng(SEED + 150)
    dev = lambda a, dt=torch.float32: torch.from_numpy(
        np.asarray(a, np.float32)).to("cuda", dt)
    params = lambda out1, in2: (
        dev(1.0 + 0.1 * rng.normal(size=C)), dev(0.1 * rng.normal(size=C)),
        dev(rng.normal(size=(out1, C)) / np.sqrt(C)),
        dev(0.02 * rng.normal(size=out1)),
        dev(rng.normal(size=(C, in2)) / np.sqrt(in2)),
        dev(0.02 * rng.normal(size=C)))
    x = dev(rng.normal(size=(B, N, C)), torch.bfloat16)
    do = dev(rng.normal(size=(B, N, C)), torch.bfloat16)
    attn_p, mlp_p = params(3 * C, C), params(HIDDEN, HIDDEN)
    images = torch.from_numpy(rng.integers(0, 256, (B, 224, 224, 3),
                                           dtype=np.uint8)).cuda()
    cases = [
        ("fused_block_attention (row 1)",
         lambda x, *p: ops.fused_block_attention(x, *p, H), (x, *attn_p)),
        ("fused_block_attention_bwd (row 1b)",
         lambda x, *p: attention.block_attention_bwd_cuda(
             x, *p[:6], p[6], H, 1e-6), (x, *attn_p, do)),
        ("fused_block_mlp (row 2)",
         lambda x, *p: ops.fused_block_mlp(x, *p), (x, *mlp_p)),
        ("fused_block_mlp_bwd (row 2b)",
         lambda x, *p: mlp.block_mlp_bwd_cuda(x, *p[:6], p[6], 1e-6),
         (x, *mlp_p, do)),
        ("normalize_images (row 3)",
         lambda im: ops.normalize_images(im, "vit"), (images,)),
    ]
    for M, K, Nn, pro in CONV_BN_SHAPES:
        xu, a, b, w, dy, ds1, ds2 = _unit_inputs(M, K, Nn, rng)
        y = conv_bn.conv1x1_bn_stats_cuda(xu, a, b, w, pro)[0]
        cases += [
            (f"conv1x1_bn_stats (row 10) M={M} K={K} N={Nn} prologue={pro}",
             lambda *t, pro=pro: conv_bn.conv1x1_bn_stats_cuda(*t, pro),
             (xu, a, b, w)),
            (f"conv1x1_bn_stats_bwd (row 10b) M={M} K={K} N={Nn} "
             f"prologue={pro}",
             lambda *t, pro=pro: conv_bn.conv1x1_bn_stats_bwd_cuda(*t, pro),
             (xu, a, b, w, y, dy, ds1, ds2))]
    flat = lambda out: [t for t in (out if isinstance(out, (tuple, list))
                                    else (out,)) if t is not None]
    with torch.no_grad():
        for name, fn, args in cases:
            fn(*args)                           # eager first: build, attrs
            torch.cuda.synchronize()
            static = [a.clone() for a in args]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = flat(fn(*static))
            # new inputs: each argument rolled by one along its first axis
            new = [torch.roll(a, 1, 0) for a in args]
            for s, n in zip(static, new):
                s.copy_(n)
            graph.replay()
            torch.cuda.synchronize()
            ref = flat(fn(*new))
            torch.cuda.synchronize()
            if len(ref) != len(outs) or not all(
                    torch.equal(o, r) for o, r in zip(outs, ref)):
                raise AssertionError(f"capture: {name}: the replay differs "
                                     f"from the eager launch")
            print(f"capture: {name}: captured alone, replayed on new inputs "
                  f"copied into its static buffers: {len(outs)} outputs "
                  f"bit-identical to the eager launch", flush=True)
            del graph, outs, static, new, ref
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 26: run control (--resume, --init_checkpoint, -t/--tracking)
# --------------------------------------------------------------------------

RC_BATCH = 10                   # phase 26's CLI batch: a ragged last batch


def _rc_epoch_lines(text: str) -> list:
    """A CLI run's per-epoch lines: losses, accuracies, early stopping."""
    return [ln for ln in text.splitlines() if ln.startswith(
        ("Train loss", "Validation loss", "EarlyStopping"))]


def _rc_saves(text: str) -> list:
    """(epoch, bytes, save s, epoch s) of each resume save a run printed."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("resume state saved to "):
            head, _, tail = ln.partition(": epoch ")
            epoch, rest = tail.split(", ", 1)
            nbytes, rest = rest.split(" bytes in ")
            save_s, rest = rest.split(" s (the epoch took ")
            out.append((int(epoch), int(nbytes), float(save_s),
                        float(rest.rstrip(" s)"))))
    return out


def _rc_equal(label: str, a, b, path: str = "") -> None:
    """a and b (tensors, numbers, nested dicts and lists) bit-identical."""
    if isinstance(a, torch.Tensor):
        if not (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b)):
            raise AssertionError(f"run control: {label}: {path} differs")
    elif isinstance(a, dict):
        if list(a) != list(b):
            raise AssertionError(f"run control: {label}: {path} keys differ")
        for k in a:
            _rc_equal(label, a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"run control: {label}: {path} lengths")
        for i, (x, y) in enumerate(zip(a, b)):
            _rc_equal(label, x, y, f"{path}/{i}")
    elif a != b:
        raise AssertionError(f"run control: {label}: {path}: {a} != {b}")


def _rc_image_launches(arch: str, counts: dict, train_epochs: int,
                       valid_epochs: int, test: bool) -> dict:
    """The kernels' launches of a train_baseline run of that many train and
    valid epochs (and the test pass) at RC_BATCH, gate open for ResNet."""
    nb = lambda n: -(-n // RC_BATCH)
    train = train_epochs * nb(counts["train"])
    evals = valid_epochs * nb(counts["validation"]) + test * nb(
        counts["test"])
    if arch == "resnet":
        full = train_epochs * (counts["train"] // RC_BATCH)
        return {"conv1x1_bn_stats": RESNET_UNITS * full,
                "conv1x1_bn_stats_bwd": RESNET_UNITS * full,
                "normalize_images": train + evals}
    return {"fused_block_attention": 12 * (train + evals),
            "fused_block_mlp": 12 * (train + evals),
            "fused_block_attention_bwd": 12 * train,
            "fused_block_mlp_bwd": 12 * train,
            "normalize_images": train + evals}


def _rc_resume(arch: str, root: Path, counts: dict, total: dict) -> dict:
    """Part 1-3 for one architecture: --epochs 3 --resume A uninterrupted;
    --epochs 1 then 3 with --resume B; the same pair with --resident_data
    (R). B and R against A bit for bit: the best checkpoint, the final
    payload (parameters, BN buffers, Adam's state, host step, early-stop
    state, generator), the epochs' printed lines and the test accuracy.
    Returns the seconds and bytes of every save."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli import train_baseline

    base = ["--dataset_path", str(root / "dataset"), "--image_path",
            str(root / "images"), "--architecture", arch, "--label",
            "style", "--batch", str(RC_BATCH), "--num_workers", "4",
            "--device", "cuda"]
    name = f"style_{arch}_baseline_single-task_checkpoint.pt"
    runs = {"A": [(3, [])], "B": [(1, []), (3, [])],
            "R": [(1, ["--resident_data"]), (3, ["--resident_data"])]}
    saved = config.CHECKPOINTS_DIR
    results, saves = {}, []
    try:
        for key, legs in runs.items():
            config.CHECKPOINTS_DIR = str(root / f"ckpt_{arch}_{key}")
            lines, done = [], 0
            for epochs, extra in legs:
                label = f"{arch} {key} --epochs {epochs}{' ' if extra else ''}" \
                        f"{' '.join(extra)}"
                with _conv_bn_gate(arch == "resnet"), _deterministic():
                    acc, text, c = _run_cli(
                        label, train_baseline.main,
                        [*base, "--epochs", str(epochs), "--resume",
                         str(root / f"resume_{arch}_{key}"), *extra],
                        phase="run control")
                for k, n in c.items():
                    total[k] = total.get(k, 0) + n
                _expect_launches(label, c, _rc_image_launches(
                    arch, counts, epochs - done, epochs - done, True),
                    phase="run control")
                if done and f"resumed from {root / f'resume_{arch}_{key}'}:" \
                        f" epoch {done}, step" not in text:
                    raise AssertionError(f"run control: {label}: no "
                                         f"'resumed from' line")
                lines += _rc_epoch_lines(text)
                saves += [(arch, key, *s) for s in _rc_saves(text)]
                done = epochs
            results[key] = (acc, lines, torch.load(
                root / f"ckpt_{arch}_{key}" / name, map_location="cpu",
                weights_only=True), torch.load(
                root / f"resume_{arch}_{key}" / "state.pt",
                map_location="cpu", weights_only=True))
    finally:
        config.CHECKPOINTS_DIR = saved
    acc_a, lines_a, best_a, state_a = results["A"]
    if len(lines_a) < 6 or state_a["epoch"] != 3:
        raise AssertionError(f"run control: {arch}: A printed {lines_a}")
    for key in ("B", "R"):
        acc, lines, best, state = results[key]
        if acc != acc_a or lines != lines_a:
            raise AssertionError(f"run control: {arch} {key}: accuracy "
                                 f"{acc} != {acc_a} or lines {lines} != "
                                 f"{lines_a}")
        _rc_equal(f"{arch} {key} best checkpoint", best, best_a)
        _rc_equal(f"{arch} {key} payload", state, state_a)
    model = state_a["model"]
    bn = sum(1 for k in model if k.endswith(("running_mean", "running_var")))
    moments = sum(len(v) for v in state_a["optimizer"]["state"].values())
    print(f"run control: {arch}: B (1 + 2 epochs) and R (--resident_data, "
          f"1 + 2) bit-identical to A (3 epochs, dropout 0.4): the best "
          f"checkpoint ({len(best_a)} tensors), the payload's "
          f"{len(model)} model tensors ({bn} BN statistics), "
          f"{moments} Adam state tensors, host_step "
          f"{state_a['host_step']}, early stop {state_a['early_stop']}, "
          f"{len(lines_a)} epoch lines, test accuracy {acc_a}", flush=True)
    del results, state_a, best_a, model
    for key in runs:
        shutil.rmtree(root / f"resume_{arch}_{key}", ignore_errors=True)
    return saves


def _rc_gnn(root: Path, total: dict) -> None:
    """Part 4: train_gnn_embeddings --epochs 6 --resume G, then --epochs 8
    --resume G, against an uninterrupted --epochs 8: both embedding files
    bit-identical."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli import train_gnn_embeddings
    from artgraph_tpu_torch.data.embeddings import load_embedding

    kg = _write_kg(root / "kg", SEED + 160)
    saved = config.DATASET_DIR, config.EMBEDDINGS_DIR
    config.DATASET_DIR = str(root / "kg")
    resume = root / "resume_gnn"
    embs = {}
    try:
        for tag, legs in (("resumed", (6, 8)), ("straight", (8,))):
            config.EMBEDDINGS_DIR = str(root / f"emb_{tag}")
            for epochs in legs:
                argv = ["--device", "cuda", "--epochs", str(epochs)]
                if tag == "resumed":
                    argv += ["--resume", str(resume)]
                _, text, c = _run_cli(f"gnn {tag} --epochs {epochs}",
                                      train_gnn_embeddings.main, argv,
                                      phase="run control")
                for k, n in c.items():
                    total[k] = total.get(k, 0) + n
                if epochs == 8 and tag == "resumed" and \
                        f"resumed from {resume}: epoch 6" not in text:
                    raise AssertionError("run control: gnn: no 'resumed "
                                         "from ...: epoch 6' line")
            embs[tag] = [load_embedding(str(root / f"emb_{tag}" / f"{s}.pt"))
                         for s in ("test_gnn_artwork_style_embs",
                                   "test_gnn_style_embs")]
    finally:
        config.DATASET_DIR, config.EMBEDDINGS_DIR = saved
    for a, b in zip(embs["resumed"], embs["straight"]):
        if a.shape != (kg["artwork"], 128) or not np.array_equal(a, b):
            raise AssertionError("run control: gnn: the resumed embeddings "
                                 "differ from the uninterrupted run's")
    print(f"run control: gnn: --epochs 6 --resume, then --epochs 8 --resume:"
          f" both embedding files [{kg['artwork']}, 128] bit-identical to an "
          f"uninterrupted --epochs 8", flush=True)


def _rc_warm(root: Path, counts: dict, total: dict) -> None:
    """Part 5: --init_checkpoint from a full seeded ViTSingleTask .pt saved
    by the port, from the same weights in raw timm layout, and from a raw
    torchvision-layout ResNet50 trunk. Each applied directly to the CLI's
    freshly built model (the file's tensors in place, the heads as fresh as
    before, the report's counts as expected), then through train_baseline
    for 1 epoch, which must print the same report."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import save_reference_checkpoint
    from artgraph_tpu_torch.checkpointing.torch_interop import \
        jax_counterpart_keys
    from artgraph_tpu_torch.cli import train_baseline
    from artgraph_tpu_torch.cli._common import (apply_init_checkpoint,
                                                single_task_loss)
    from artgraph_tpu_torch.models import (ResNet50, ResnetSingleTask,
                                           ViTSingleTask, init_random_)
    from artgraph_tpu_torch.train import Trainer, adam

    vit = init_random_(ViTSingleTask(32, dropout=0.4),
                       torch.Generator().manual_seed(SEED + 170))
    save_reference_checkpoint(vit, str(root / "vit_full.pt"))
    timm = {k[len("vit."):]: v.float() for k, v in vit.state_dict().items()
            if not k.startswith("vit.head.")}
    timm["head.weight"] = torch.zeros(1000, C)
    timm["head.bias"] = torch.zeros(1000)
    torch.save(timm, root / "vit_timm.pt")
    tv = _seeded_resnet_(ResNet50(named=True), SEED + 180)
    raw = {k: v.float() for k, v in tv.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    raw["fc.weight"] = torch.zeros(1000, 2048)
    raw["fc.bias"] = torch.zeros(1000)
    torch.save(raw, root / "resnet_torchvision.pt")
    del vit, tv

    cases = (("vit", "ViTSingleTask", "vit_full.pt", "full model", None),
             ("vit", "ViTSingleTask", "vit_timm.pt", "trunk only",
              "params/head"),
             ("resnet", "ResnetSingleTask", "resnet_torchvision.pt",
              "trunk only", "params/classifier"))
    saved = config.CHECKPOINTS_DIR
    try:
        for arch, model_name, fname, scope, head in cases:
            path = str(root / fname)
            torch.manual_seed(config.GLOBAL_SEED)   # as the CLI builds it
            model = (ResnetSingleTask if arch == "resnet"
                     else ViTSingleTask)(32, 0.4)
            trainer = Trainer(model, adam(3e-4), single_task_loss(None,
                                                                  "cuda"),
                              transform_type=arch, device="cuda")
            before = {k: v.clone() for k, v in model.state_dict().items()}
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                imported, fresh = apply_init_checkpoint(trainer, model_name,
                                                        path)
            report = out.getvalue().strip()
            keys = jax_counterpart_keys(model_name, before)
            n_head = sum(1 for k in keys if k.startswith(
                ("classifier.", "vit.head.")))
            tops = {"vit_full.pt": "params/head, params/vit",
                    "vit_timm.pt": "params/vit",
                    "resnet_torchvision.pt":
                        "batch_stats/resnet, params/resnet"}[fname]
            want = (f"init_checkpoint {path}: {scope}; imported "
                    f"{len(keys) - n_head if head else len(keys)} tensors "
                    f"({tops}); fresh {1 if head else 0} ({head or 'none'})")
            if report != want:
                raise AssertionError(f"run control: warm {fname}: report "
                                     f"{report!r}, expected {want!r}")
            src = torch.load(path, map_location="cpu", weights_only=True)
            got = model.state_dict()
            for k in imported:
                sk = (k if fname == "vit_full.pt" else
                      k[len("vit."):] if arch == "vit" else
                      _tv_name(k))
                if not torch.equal(got[k].cpu(), src[sk].to(got[k].dtype)):
                    raise AssertionError(f"run control: warm {fname}: {k} "
                                         f"is not the file's {sk}")
            for k in fresh:
                if not torch.equal(got[k], before[k]):
                    raise AssertionError(f"run control: warm {fname}: the "
                                         f"fresh {k} changed")
            del trainer, model, before, got
            config.CHECKPOINTS_DIR = str(root / f"ckpt_warm_{fname}")
            label = f"{arch} --init_checkpoint {fname}"
            with _conv_bn_gate(arch == "resnet"):
                _, text, c = _run_cli(
                    label, train_baseline.main,
                    ["--dataset_path", str(root / "dataset"), "--image_path",
                     str(root / "images"), "--architecture", arch, "--label",
                     "style", "--batch", str(RC_BATCH), "--num_workers", "4",
                     "--device", "cuda", "--epochs", "1",
                     "--init_checkpoint", path], phase="run control")
            for k, n in c.items():
                total[k] = total.get(k, 0) + n
            _expect_launches(label, c, _rc_image_launches(arch, counts, 1, 1,
                                                          True),
                             phase="run control")
            if report not in text.splitlines():
                raise AssertionError(f"run control: {label}: the CLI did "
                                     f"not print {report!r}")
            print(f"run control: warm {fname} into {model_name}: {scope}, "
                  f"{len(imported)} tensors imported equal to the file's, "
                  f"{len(fresh)} fresh unchanged; the CLI printed the same "
                  f"report and trained 1 epoch", flush=True)
    finally:
        config.CHECKPOINTS_DIR = saved


def _tv_name(key: str) -> str:
    """A ResnetSingleTask trunk key (resnet.4.0.conv1.weight) as raw
    torchvision names it (layer1.0.conv1.weight)."""
    index = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
             "6": "layer3", "7": "layer4"}
    child, _, rest = key[len("resnet."):].partition(".")
    return f"{index[child]}.{rest}"


def _rc_tracking(root: Path, untracked: dict) -> dict:
    """Part 6: train_baseline --architecture vit --epochs 1 -t into a file
    store under root: its per-epoch metric values equal the printed ones,
    and its launches and printed lines equal those of the same run without
    -t (tracking adds no work to a step)."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli import train_baseline
    from artgraph_tpu_torch.tracking import mlflow_adapter

    saved = config.CHECKPOINTS_DIR, mlflow_adapter._store
    config.CHECKPOINTS_DIR = str(root / "ckpt_tracked")
    mlflow_adapter._store = mlflow_adapter._FileStore(str(root / "mlruns"))
    try:
        with _deterministic():
            acc, text, c = _run_cli(
                "vit -t", train_baseline.main,
                ["--dataset_path", str(root / "dataset"), "--image_path",
                 str(root / "images"), "--architecture", "vit", "--label",
                 "style", "--batch", str(RC_BATCH), "--num_workers", "4",
                 "--device", "cuda", "--epochs", "1", "-t", "--exp",
                 "chip_smoke"], phase="run control")
    finally:
        config.CHECKPOINTS_DIR, mlflow_adapter._store = saved
    if mlflow_adapter._mlflow is not None:
        print("run control: tracking: mlflow is installed here; the file "
              "store is not checked", flush=True)
        return c
    (run_id,) = os.listdir(root / "mlruns" / "chip_smoke")
    metrics = root / "mlruns" / "chip_smoke" / run_id / "metrics"
    read = lambda n: [ln.split()[1:] for ln in
                      (metrics / n).read_text().splitlines()]
    train = [ln for ln in text.splitlines() if ln.startswith("Train loss")]
    valid = [ln for ln in text.splitlines()
             if ln.startswith("Validation loss: ")]
    for name, lines in (("train", train), ("valid", valid)):
        loss, acc_text = lines[0].split(": ", 1)[1].split("; ")
        want = {"loss": [[str(float(loss)), "0"]],
                "acc": [[str(float(acc_text.split(": ")[1])), "0"]]}
        for metric, rows in want.items():
            if read(f"{name} {metric}") != rows:
                raise AssertionError(f"run control: tracking: {name} "
                                     f"{metric} {read(f'{name} {metric}')} "
                                     f"!= printed {rows}")
    if read("test acc") != [[str(acc), "0"]]:
        raise AssertionError("run control: tracking: test acc")
    if c != untracked["counts"] or _rc_epoch_lines(text) != \
            untracked["lines"]:
        raise AssertionError(f"run control: tracking: launches {c} or "
                             f"lines differ from the untracked run's "
                             f"{untracked['counts']}")
    print(f"run control: tracking: -t wrote {sorted(os.listdir(metrics))} "
          f"equal to the printed values; launches and epoch lines equal to "
          f"the untracked run's", flush=True)
    return c


def run_control_phase() -> dict:
    """Phase 26: the trainers' run control on the card; returns every
    kernel's launches over its runs."""
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        counts = _load_synth().make_image_tree(root)
        if counts["train"] % RC_BATCH == 0:
            raise AssertionError("run control: the last batch is not ragged")
        saves = []
        for arch in ("vit", "resnet"):
            saves += _rc_resume(arch, root, counts, total)
        for arch, key, epoch, nbytes, save_s, epoch_s in saves:
            print(f"run control: save cost: {arch} {key} epoch {epoch}: "
                  f"{nbytes} bytes in {save_s:.3f} s beside an epoch of "
                  f"{epoch_s:.3f} s ({counts['train']} train, "
                  f"{counts['validation']} valid images)", flush=True)
        # part 6's reference: the tracked run's arguments without -t
        from artgraph_tpu_torch import config
        from artgraph_tpu_torch.cli import train_baseline
        saved = config.CHECKPOINTS_DIR
        config.CHECKPOINTS_DIR = str(root / "ckpt_untracked")
        try:
            with _deterministic():
                _, text, c = _run_cli(
                    "vit untracked", train_baseline.main,
                    ["--dataset_path", str(root / "dataset"), "--image_path",
                     str(root / "images"), "--architecture", "vit",
                     "--label", "style", "--batch", str(RC_BATCH),
                     "--num_workers", "4", "--device", "cuda", "--epochs",
                     "1"], phase="run control")
        finally:
            config.CHECKPOINTS_DIR = saved
        untracked = {"counts": c, "lines": _rc_epoch_lines(text)}
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
        for k, n in _rc_tracking(root, untracked).items():
            total[k] = total.get(k, 0) + n
        _rc_gnn(root, total)
        _rc_warm(root, counts, total)
    return total


# --------------------------------------------------------------------------
# Phase 27: data parallelism (parallel/, the Trainer's mesh step, the
# edge-sharded GNN, --data_parallel)
# --------------------------------------------------------------------------

DP_STEPS = 4                    # (a): steps of each exactness run
DP_REL_L2 = 1e-4                # (a): world 1 against one device, 4 steps,
                                # or DP_FLOOR_FACTOR x the rows-reversed floor
DP_LOSS_REL = 1e-2              # (b): the loss, two ranks against one
DP_F32_REL = 1e-3               # (b): f32 gradients (1e-4: the f32 loss)
DP_FLOOR_FACTOR = 2.0           # (a), (b): at most this times the floor
DP_STEM_REL = 1e-4              # (b): the stem BN's statistics' updates
FLOOR_OF = {"resnet": "bf16 against f32", "resnet gate off":
            "bf16 against f32", "resnet f32": "f32 against f64"}
DP_BLOCK = B // 2               # (b): each rank's rows of the global batch


def _dp_mesh_world1(tmp: str):
    """A one-rank NCCL group in this process over a file in tmp, and its
    mesh."""
    from artgraph_tpu_torch.parallel.mesh import create_mesh, distributed_init

    device = torch.device("cuda", 0)
    distributed_init(f"file://{tmp}/rendezvous", 1, 0, "nccl", device)
    return create_mesh(1, device)


def _dp_trainer(spec, model, mesh=None):
    from artgraph_tpu_torch.train import Trainer

    _, _, opt, loss, transform, inputs, _, _, _ = spec
    return Trainer(model, opt, loss, transform_type=transform, device="cuda",
                   forward_inputs=inputs, mesh=mesh)


class _RowsReversed:
    """_Rows with each batch of B rows in reverse order: the same batches'
    gradients in another summation order (the bf16 floor of (a))."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.rows.get_batch(idx // B * B + B - 1 - idx % B)


def _dp_world1(spec, mesh) -> dict:
    """(a) for one model at dropout 0: DP_STEPS steps of train_epoch over
    the world-1 NCCL mesh (its graphed step, the collectives captured)
    against the one-device graphed step (phase 23's) from the same weights
    on the same batches, under cuDNN's deterministic algorithms: the
    losses, parameters and BN statistics, each within DP_REL_L2 or
    DP_FLOOR_FACTOR times its distance between two one-device runs whose
    batches differ only in row order (the floor: a random-init ResNet50's
    bf16 steps are chaotic); then both timed in turns (GRAPH_WINDOWS
    windows of an epoch of DP_STEPS steps each way, medians), the device's
    busy ms, idle share and NCCL's share of the busy time by the profiler,
    and the launches a step by the counters."""
    import copy

    from artgraph_tpu_torch.data.loader import DataLoader
    from artgraph_tpu_torch.ops import launches

    label, make, *_, gate, per_step = spec
    rows = _Rows(DP_STEPS * B, SEED + 270)
    src = _set_dropout(make(), 0.0)
    trainers = {"one device": _dp_trainer(spec, copy.deepcopy(src)),
                "rows reversed": _dp_trainer(spec, copy.deepcopy(src)),
                "world 1": _dp_trainer(spec, src, mesh)}
    loaders = {"one device": DataLoader(rows, B, num_workers=4),
               "rows reversed": DataLoader(_RowsReversed(rows), B,
                                           num_workers=4),
               "world 1": DataLoader(rows, B, num_workers=4, mesh=mesh)}
    with _conv_bn_gate(gate), _deterministic():
        losses = {k: t.train_epoch(loaders[k])["loss"]
                  for k, t in trainers.items()}
        torch.cuda.synchronize()
        one = trainers["one device"]
        dist = {}
        for k in ("world 1", "rows reversed"):
            m = trainers[k].model
            dist[k] = (*_state_distance(m, one.model, False),
                       *_state_distance(m, one.model, True),
                       abs(losses[k] - losses["one device"]))
        p_abs, p_rel, b_abs, b_rel, loss_err = dist["world 1"]
        _, fp, _, fb, fl = dist["rows reversed"]
        bounds = [max(DP_REL_L2, DP_FLOOR_FACTOR * f) for f in (fp, fb)]
        loss_bound = max(DP_REL_L2 * losses["one device"],
                         DP_FLOOR_FACTOR * fl)
        same = loss_err == 0 and p_abs == 0 and b_abs == 0
        dp = trainers["world 1"]
        print(f"dp world 1: {label}, dropout 0, {DP_STEPS} steps of "
              f"train_epoch over a one-rank NCCL mesh (graphs "
              f"{len(dp.graphs)}) against the one-device graphed step from "
              f"the same weights: epoch loss {losses['world 1']:.6f} against "
              f"{losses['one device']:.6f} (|diff| {loss_err:.3g}, bound "
              f"{loss_bound:.3g}); parameters max |diff| {p_abs:.3g}, rel L2 "
              f"{p_rel:.3g} (bound {bounds[0]:.3g}); BN buffers max |diff| "
              f"{b_abs:.3g}, rel L2 {b_rel:.3g} (bound {bounds[1]:.3g}); "
              f"the floor, one device with each batch's rows reversed: "
              f"loss |diff| {fl:.3g}, parameters rel L2 {fp:.3g}, BN "
              f"buffers rel L2 {fb:.3g}"
              + ("; bit-identical" if same else ""), flush=True)
        if len(dp.graphs) != 1 or not (
                same or (p_rel <= bounds[0] and b_rel <= bounds[1]
                         and loss_err <= loss_bound)):
            raise AssertionError(f"dp world 1: {label}: the mesh's steps "
                                 f"differ from the one device's")
        del trainers["rows reversed"], loaders["rows reversed"]
        ms = {k: [] for k in trainers}
        for _ in range(GRAPH_WINDOWS):
            for k, t in trainers.items():
                t0 = time.perf_counter()
                t.train_epoch(loaders[k])
                torch.cuda.synchronize()
                ms[k].append(1e3 * (time.perf_counter() - t0) / DP_STEPS)
        out = {}
        for k, t in trainers.items():
            before = launches.snapshot()
            events = _trace_events(lambda: t.train_epoch(loaders[k]), 1)
            counted = launches.since(before)
            kernels = [ev for ev in events if ev.get("cat") in DEVICE_WORK]
            busy = sum(ev.get("dur", 0.0) for ev in kernels) / DP_STEPS / 1e3
            nccl = sum(ev.get("dur", 0.0) for ev in kernels
                       if "nccl" in ev.get("name", "").lower()
                       ) / DP_STEPS / 1e3
            step_ms = float(np.median(ms[k]))
            per = {name: counted.get((mod.__name__, attr), 0)
                   / (2 * DP_STEPS)
                   for name, (mod, attr) in {**_counters(),
                                             **_conv_bn_counters()}.items()}
            out[k] = {"ms": step_ms, "busy_ms": busy, "nccl_ms": nccl,
                      "idle": max(0.0, 1 - busy / step_ms) if busy else None,
                      "launches": {n: v for n, v in per.items() if v}}
    fmt = lambda m: (f"{m['ms']:.3f} ms/step, device busy "
                     f"{m['busy_ms']:.3f} ms, idle share "
                     + ("not measured" if m["idle"] is None
                        else f"{m['idle']:.4f}")
                     + f", NCCL {m['nccl_ms']:.4f} ms "
                       f"({m['nccl_ms'] / max(m['busy_ms'], 1e-9):.4%} of "
                       f"busy), launches a step {m['launches']}")
    one, dp = out["one device"], out["world 1"]
    print(f"dp world 1: {label}, batch {B}, in turns ({GRAPH_WINDOWS} "
          f"windows of {DP_STEPS} steps each way, medians): one device "
          f"{fmt(one)} | world 1 {fmt(dp)} | world 1 / one device ms "
          f"{dp['ms'] / one['ms']:.4f}x, device busy "
          f"{dp['busy_ms'] - one['busy_ms']:+.3f} ms a step", flush=True)
    want = {k: float(v) for k, v in per_step.items()}
    for k in out:
        if out[k]["launches"] != want:
            raise AssertionError(f"dp world 1: {label}: {k}: launches a "
                                 f"step {out[k]['launches']}, expected "
                                 f"{want}")
    del trainers, src
    torch.cuda.empty_cache()
    return out


def _dp_resnet_spec(dtype: torch.dtype):
    """Phase 13's ResNet50 (the same weights) in `dtype`, the gate closed;
    in f64 its parameters too (the head's Linear takes the f64 features)."""
    from artgraph_tpu_torch.models import ResnetSingleTask

    spec = list(_graph_specs()[2])
    spec[0] = f"ResnetSingleTask(32) ResNet50 {dtype}, gate off"
    spec[1] = lambda: _seeded_resnet_(
        ResnetSingleTask(32, dropout=0.4, dtype=dtype), SEED + 80).to(
            torch.promote_types(dtype, torch.float32))
    return tuple(spec)


def _dp_image_specs() -> dict:
    """(b)'s image models: phase 6's ViT-B/16, phase 13's ResNet50 (bf16)
    with the unit's gate open and closed, and the same ResNet50 in f32."""
    specs = _graph_specs()
    return {"vit": specs[0], "resnet": specs[1], "resnet gate off": specs[2],
            "resnet f32": _dp_resnet_spec(torch.float32)}


def _dp_image_step(spec, mesh, images, labels):
    """One eager step of spec's model at dropout 0 (over `mesh` on this
    rank's block of the batch): (loss, {name: f32 CPU gradient}, the BN
    statistics' updates, the counters of the step)."""
    from artgraph_tpu_torch.parallel.mesh import batch_sharding

    _, make, *_, gate, _ = spec
    model = _set_dropout(make(), 0.0)
    before = {n: b.double().clone() for n, b in model.named_buffers()
              if "running" in n}
    trainer = _dp_trainer(spec, model, mesh)
    batch = (np.ascontiguousarray(images), np.ascontiguousarray(labels),
             np.ones(len(labels), np.float32))
    if mesh is not None:
        batch = batch_sharding(mesh, batch)
    _zero_counts()
    with _conv_bn_gate(gate):
        loss, _ = trainer.train_step(trainer.to_device(batch))
        torch.cuda.synchronize()
    counts = {**_all_counts(), **_read_counts(_csr_counters)}
    grads = {n: p.grad.detach().float().cpu()
             for n, p in trainer.model.named_parameters()}
    stats = None
    if before:
        # every BN layer's, then the stem's alone (before any bottleneck)
        stem = {n: t for n, t in before.items() if n.startswith("resnet.1.")}
        stats = (_bn_updates(trainer.model, before),
                 torch.cat([(dict(trainer.model.named_buffers())[n]
                             .detach().cpu().double() - t).flatten()
                            for n, t in stem.items()]))
    return float(loss), grads, stats, {k: v for k, v in counts.items() if v}


def _dp_gnn_step(graph, mesh=None):
    """One GNN step of phase 9's model at dropout 0.4 with the generator
    seeded alike (every rank draws the same masks), edge-sharded over
    `mesh`: (loss, {name: f32 CPU gradient}, the counters)."""
    from artgraph_tpu_torch.parallel.gnn_parallel import (
        device_put_graph_csr, init_variables)
    from artgraph_tpu_torch.parallel.mesh import sync_grads

    model = _gnn_model(graph, 0.4, None if mesh is None
                       else mesh.axis_name).cuda().train()
    if mesh is None:
        x, edges, csr, y = _graph_on(graph, "cuda")
    else:
        init_variables(model, mesh)
        x, edges, csr = device_put_graph_csr(graph, mesh)
        y = torch.from_numpy(graph.labels["y_style"].astype(np.int64)).cuda()
    gen = torch.Generator("cuda").manual_seed(SEED)
    _zero_counts()
    loss, _ = _gnn_loss(model, x, edges, csr, y, gen)
    loss.backward()
    if mesh is not None:
        sync_grads(model.parameters(), mesh)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _read_counts(_csr_counters).items() if v}
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads, counts


def _flat(grads: dict, pick=lambda n: True) -> torch.Tensor:
    return torch.cat([g.double().flatten() for n, g in sorted(grads.items())
                      if pick(n)])


def _dp_trunk(name: str):
    """The trunk parameters' test of an image model of (b)."""
    prefix = "vit." if name == "vit" else "resnet."
    return lambda n: n.startswith(prefix) and not n.startswith("vit.head.")


def _dp_quantities(name: str, loss, grads, stats) -> dict:
    trunk = _dp_trunk(name)
    out = {"loss": loss, "trunk": _flat(grads, trunk),
           "head": _flat(grads, lambda n: not trunk(n))}
    if stats is not None:
        out["bn"], out["bn stem"] = stats
    return out


def _dp_rank_shared(mesh, tmp: str) -> None:
    """(b)'s rank body: one eager step of each model on this rank's block
    (the image models of _dp_image_specs) or edge shard (the GNN) over
    gloo, every rank on cuda:0; the distances from the one-process step
    (saved in tmp by the parent) and the rank's launches into
    tmp/rank<r>.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs = _dp_image_specs()
    images, labels = specs["vit"][6](np.random.default_rng(SEED + 271), B)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    out = {}
    for name, spec in specs.items():
        loss, grads, stats, counts = _dp_image_step(spec, mesh, images,
                                                    labels)
        got = _dp_quantities(name, loss, grads, stats)
        ref = torch.load(os.path.join(tmp, f"{name}.pt"))
        out[name] = {q: rel(got[q], ref[q]) for q in got if q != "loss"}
        out[name].update(loss=loss, ref_loss=ref["loss"], launches=counts)
        del grads, got
        torch.cuda.empty_cache()
    graph = _bench_graph(GNN_ARTWORKS, GNN_EDGES, 5_000, 10_000, SEED)
    loss, grads, counts = _dp_gnn_step(graph, mesh)
    ref = torch.load(os.path.join(tmp, "gnn.pt"))
    out["gnn"] = {"loss": loss, "ref_loss": ref["loss"],
                  "grad": rel(_flat(grads), ref["grad"]),
                  "launches": counts}
    with open(os.path.join(tmp, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def _dp_shared_card(tmp: str) -> dict:
    """(b): the one-process steps on the card, and each ResNet quantity's
    floor (its dtype's own error: the one-process step in bf16 against
    f32, f32 against f64; a rank's 16 rows get other convolution
    algorithms than 32, whose rounding a random-init ResNet50 amplifies),
    then two gloo ranks sharing cuda:0, each running _dp_rank_shared; each
    quantity held to max(the dtype's bound, DP_FLOOR_FACTOR x its floor),
    the stem BN's statistics (before any amplification) to DP_STEM_REL,
    every kernel of the path launched on both ranks. Returns the ranks'
    launches summed."""
    from artgraph_tpu_torch.parallel.mesh import spawn

    specs = _dp_image_specs()
    images, labels = specs["vit"][6](np.random.default_rng(SEED + 271), B)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    refs = {}
    for name, spec in (*specs.items(),
                       ("resnet f64", _dp_resnet_spec(torch.float64))):
        refs[name] = _dp_quantities(name, *_dp_image_step(
            spec, None, images, labels)[:3])
        if name in specs:
            torch.save(refs[name], os.path.join(tmp, f"{name}.pt"))
        torch.cuda.empty_cache()
    # each ResNet quantity's floor: its own dtype's error on one process,
    # bf16 against f32 and f32 against f64 (a random-init ResNet50 step is
    # chaotic, PERF.md §6; the stem BN, before any bottleneck, is held
    # tight instead)
    floors = {}
    for name, ref in (("resnet", "resnet f32"),
                      ("resnet gate off", "resnet f32"),
                      ("resnet f32", "resnet f64")):
        a, b = refs[name], refs[ref]
        floors[name] = {q: rel(a[q], b[q]) for q in a
                        if q not in ("loss", "bn stem")}
        floors[name]["loss"] = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    del refs
    graph = _bench_graph(GNN_ARTWORKS, GNN_EDGES, 5_000, 10_000, SEED)
    loss, grads, _ = _dp_gnn_step(graph)
    torch.save({"loss": loss, "grad": _flat(grads)},
               os.path.join(tmp, "gnn.pt"))
    del graph, grads
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(_dp_rank_shared, 2, "gloo", init_file=os.path.join(tmp, "rdv"),
          timeout=900.0, args=(tmp,), devices=["cuda:0", "cuda:0"])
    seconds = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    expect = {"vit": ("fused_block_attention", "fused_block_mlp",
                      "normalize_images", "fused_block_attention_bwd",
                      "fused_block_mlp_bwd"),
              "resnet": ("conv1x1_bn_stats", "conv1x1_bn_stats_bwd",
                         "normalize_images"),
              "resnet gate off": ("normalize_images",),
              "resnet f32": ("normalize_images",),
              "gnn": ("csr_segment_sum", "csr_attention_aggregate",
                      "csr_scalar_segment_sum")}
    least = {"vit": (DP_LOSS_REL, TRAIN_GRAD_REL_L2),
             "resnet": (DP_LOSS_REL, TRAIN_GRAD_REL_L2),
             "resnet gate off": (DP_LOSS_REL, TRAIN_GRAD_REL_L2),
             "resnet f32": (1e-4, DP_F32_REL),
             "gnn": (DP_F32_REL, GNN_GRAD_REL_L2)}
    total: dict = {}
    failed = []
    for r, got in enumerate(ranks):
        for name, res in got.items():
            res["loss_rel"] = abs(res["loss"] - res["ref_loss"]) / \
                abs(res["ref_loss"])
            parts, ok = [f"loss {res['loss']:.6f} against "
                         f"{res['ref_loss']:.6f}"], True
            for q in ("loss_rel", "trunk", "head", "bn", "bn stem", "grad"):
                if q not in res:
                    continue
                floor = floors.get(name, {}).get(
                    "loss" if q == "loss_rel" else q)
                low = (DP_STEM_REL if q == "bn stem"
                       else least[name][q != "loss_rel"])
                bound = low if floor is None else max(
                    low, DP_FLOOR_FACTOR * floor)
                what = {"loss_rel": "loss rel", "trunk": "trunk gradient",
                        "head": "head gradient",
                        "bn": "BN statistics' updates",
                        "bn stem": "the stem BN's updates",
                        "grad": "gradient"}[q]
                parts.append(f"{what}" + ("" if q == "loss_rel" else
                                          " rel L2")
                             + f" {res[q]:.4g} (bound {bound:.4g}"
                             + ("" if floor is None else
                                f"; {FLOOR_OF[name]} on one process "
                                f"{floor:.4g}") + ")")
                ok = ok and res[q] <= bound
            missing = [k for k in expect[name]
                       if not res["launches"].get(k)]
            print(f"dp shared card: rank {r} of 2 (gloo, both on cuda:0), "
                  f"{name}, one eager step on "
                  + ("its edge shard" if name == "gnn" else
                     f"its {DP_BLOCK} rows of the batch of {B}")
                  + f" against one process: {'; '.join(parts)}; launches "
                    f"{res['launches']}", flush=True)
            if not ok or missing:
                failed.append(f"rank {r}, {name}: out of bounds or no "
                              f"launch of {missing}")
            for k, v in res["launches"].items():
                total[k] = total.get(k, 0) + v
    if failed:
        raise AssertionError(f"dp shared card: {'; '.join(failed)}")
    print(f"dp shared card: two ranks in {seconds:.1f} s (spawn, build "
          f"load, the 8M-edge graph and its shards on each)", flush=True)
    return total


def _dp_cli(tmp: str) -> None:
    """(c): cli.train_baseline --architecture vit and
    cli.train_gnn_embeddings with --data_parallel 1 on cuda (each starts
    one NCCL rank in a process of its own, whose graphed steps capture the
    collectives) on phase 15's synthetic tree and phase 11's KG: the rank's
    result, the checkpoint and the embeddings; --data_parallel 2 refused
    with the device-count error."""
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli import train_baseline, train_gnn_embeddings
    from artgraph_tpu_torch.data.embeddings import load_embedding

    root = Path(tmp)
    counts = _load_synth().make_image_tree(root / "tree")
    argv = ["--dataset_path", str(root / "tree" / "dataset"),
            "--image_path", str(root / "tree" / "images"),
            "--architecture", "vit", "--label", "style", "--epochs", "1",
            "--batch", "8", "--num_workers", "4", "--device", "cuda",
            "--results_dir", str(root / "results")]
    t0 = time.perf_counter()
    acc = train_baseline.main(argv + ["--data_parallel", "1"])
    seconds = time.perf_counter() - t0
    path = (Path(config.CHECKPOINTS_DIR) /
            "style_vit_baseline_single-task_checkpoint.pt")
    model = load_reference_checkpoint("ViTSingleTask", str(path), "cuda")
    if not (root / "results" / "results.csv").exists() or \
            not 0.0 <= acc <= 1.0:
        raise AssertionError(f"dp cli: train_baseline: accuracy {acc}, no "
                             f"results.csv")
    try:
        train_baseline.main(argv + ["--data_parallel", "2"])
        raise AssertionError("dp cli: --data_parallel 2 ran on one card")
    except ValueError as e:
        refused = str(e)
    print(f"dp cli: train_baseline --architecture vit --data_parallel 1 "
          f"--device cuda, 1 epoch on {counts} synthetic images in "
          f"{seconds:.1f} s (one NCCL rank): test accuracy {acc}, "
          f"checkpoint reloaded strict ({len(model.state_dict())} tensors); "
          f"--data_parallel 2 refused: {refused}", flush=True)
    kg = _write_kg(root / "kg", SEED + 272)
    saved = {k: os.environ.get(k) for k in ("ARTGRAPH_DATASET_DIR",
                                            "ARTGRAPH_EMBEDDINGS_DIR")}
    os.environ["ARTGRAPH_DATASET_DIR"] = str(root / "kg")
    os.environ["ARTGRAPH_EMBEDDINGS_DIR"] = str(root / "emb")
    t0 = time.perf_counter()
    try:
        train_gnn_embeddings.main(["--device", "cuda", "--epochs", "6",
                                   "--data_parallel", "1"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    shapes = []
    for stem in ("test_gnn_artwork_style_embs", "test_gnn_style_embs"):
        emb = load_embedding(str(root / "emb" / f"{stem}.pt"))
        if emb.shape != (kg["artwork"], 128) or not np.isfinite(emb).all():
            raise AssertionError(f"dp cli: {stem}.pt is {emb.shape} or not "
                                 f"finite")
        shapes.append(f"{stem}.pt {list(emb.shape)}")
    print(f"dp cli: train_gnn_embeddings --data_parallel 1 --device cuda "
          f"--epochs 6 on a {kg['artwork']}-artwork KG in {seconds:.1f} s "
          f"(one NCCL rank, edge-sharded in one); reloaded "
          f"{', '.join(shapes)}, finite", flush=True)


def data_parallel_phase() -> dict:
    """Phase 27: (a) the world-1 NCCL step against the one-device graphed
    step, ViT-B/16 and ResNet50 (gate on), exact and in turns; (b) two gloo
    ranks sharing the card against one process, ViT-B/16, ResNet50 (gate
    on) and the 8M-edge GNN; (c) the CLIs with --data_parallel. Returns
    every kernel's launches over (a)'s and (b)'s runs."""
    from artgraph_tpu_torch.parallel.mesh import release_mesh

    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = _dp_mesh_world1(tmp)
        try:
            specs = _graph_specs()
            for spec in specs[:2]:
                _zero_counts()
                _dp_world1(spec, mesh)
                for k, n in _all_counts().items():
                    total[k] = total.get(k, 0) + n
        finally:
            release_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        for k, n in _dp_shared_card(tmp).items():
            total[k] = total.get(k, 0) + n
    with tempfile.TemporaryDirectory() as tmp:
        _dp_cli(tmp)
    return total


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
        gemm_kernel_phases()
        norm_kernel_phases()
        kernels = kernel_phases()
        kernels.update(csr_kernel_phases())
        scalar_normalize_phases()
        kernels.update(conv_bn_kernel_phases())
        kernels.update(attention_kernel_phases())
        launches = serve_phase()
        counts, vit_train = train_phase()
        for k, n in counts.items():
            launches[k] += n
        grad_phase()
        cli_phase(checkpoints_dir)
        launches.update(gnn_train_phase())
        gnn_grad_phase()
        gnn_cli_phase()
        launches["normalize_images"] += \
            resnet_serve_phase()["normalize_images"]
        counts, resnet_train = resnet_train_phase()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        resnet_grad_phase()
        resnet_cli_phase(checkpoints_dir)
        for phase in (vit_unfused_serve_phase, vit_unfused_train_phase,
                      attention_module_phase,
                      lambda: multimodal_train_phase(vit_train),
                      pipeline_cli_phase,
                      lambda: context_train_phase(resnet_train),
                      baseline_cli_phase):
            for k, n in phase().items():
                launches[k] = launches.get(k, 0) + n
        graph_train_phase()
        for k, n in resident_phase().items():
            launches[k] = launches.get(k, 0) + n
        capture_phase()
        for k, n in run_control_phase().items():
            launches[k] = launches.get(k, 0) + n
        for k, n in data_parallel_phase().items():
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
