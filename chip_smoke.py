#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ViT-B/16 serving and training paths once on
one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

It imports nothing of JAX or of the JAX package, and no PIL or pandas outside
the CLI phase (whose data decode and results need them). Phases, each
printing its lines; any failure raises and exits non-zero:

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
              (zero in exact arithmetic) by absolute error only; the uint8
              normalize bit-exact for both statistics
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
              kernel and the idle share.
  7. grads    one step's gradients on 2 images (dropout 0): the kernels in
              bf16 on the card against the f32 plain path on the CPU with the
              same weights; relative L2 of the concatenated trunk gradient
              <= TRAIN_GRAD_REL_L2.
  8. cli      cli.train_baseline --architecture vit --device cuda, 1 epoch
              at --batch 8 on a synthetic class-structured ArtGraph tree
              (tests/_make_synth.py), with ARTGRAPH_CHECKPOINTS_DIR in a
              temporary directory: its train/valid/test lines, and its
              checkpoint reloaded with load_reference_checkpoint.

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
SEED = 0
BATCHES = 3
TRAIN_WARMUP, TRAIN_STEPS, PROFILED_STEPS = 2, 8, 2
PEAK_FLOPS = 989e12        # H100 SXM bf16 dense
PEAK_BYTES = 3.35e12       # H100 SXM HBM3


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


def _check_grads(name: str, ours, ref) -> float:
    """dx, then each f32 parameter gradient (see phase 3); returns the max
    abs error over all of them."""
    max_abs = _check_output(f"{name} dx", ours[0], ref[0])
    names = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for gname, a, r in zip(names, ours[1:], ref[1:]):
        if a.dtype != torch.float32 or a.shape != r.shape:
            raise AssertionError(f"{name} {gname}: {a.dtype} {a.shape}")
        a, r = a.double(), r.double()
        max_abs = max(max_abs, (a - r).abs().max().item())
        note = ""
        if name == "fused_block_attention_bwd" and gname == "db1":
            # the K third is zero in exact arithmetic: absolute error only
            scale = r.abs().mean().item()
            k_err = (a[C:2 * C] - r[C:2 * C]).abs().max().item()
            note = (f"; K third max abs {k_err:.4g} (<= "
                    f"{GRAD_MAX_REL} * mean|db_qkv| = {GRAD_MAX_REL * scale:.4g})")
            if not k_err <= GRAD_MAX_REL * scale:
                raise AssertionError(f"{name} db_qkv K third: {k_err}")
            a, r = torch.cat((a[:C], a[2 * C:])), torch.cat((r[:C], r[2 * C:]))
        rel_l2 = ((a - r).norm() / r.norm()).item()
        max_rel = ((a - r).abs().max() / r.abs().mean()).item()
        print(f"check: {name} {gname} {list(r.shape)} f32: rel L2 "
              f"{rel_l2:.4g}, max|a-b|/mean|a| {max_rel:.4g}{note}",
              flush=True)
        if not (rel_l2 <= GRAD_REL_L2 and max_rel <= GRAD_MAX_REL
                and torch.isfinite(a).all()):
            raise AssertionError(f"{name} {gname} disagrees with the plain "
                                 f"backward (rel L2 {rel_l2}, max {max_rel})")
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


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms, what bounds it): FLOPs at the bf16 dense peak or bytes
    (each input read once, each output written once) at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
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
            ours = kernel()
            torch.cuda.synchronize()
            ref = plain()
            torch.cuda.synchronize()
            max_abs = (_check_grads(name, ours, ref) if name.endswith("_bwd")
                       else _check_output(name, ours, ref))
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


def _zero_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


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


def _profile_steps(step, steps: int, step_ms: float) -> None:
    """Device time by kernel over `steps` profiled steps, and the device idle
    share against the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernels.append((us / steps / 1e3, e.count // steps, e.key))
    busy = sum(ms for ms, _, _ in kernels)
    if busy <= 0:
        print("train profile: the profiler saw no device time; idle share "
              "not measured", flush=True)
        return
    kernels.sort(reverse=True)
    print(f"train profile: device busy {busy:.3f} ms per step against "
          f"{step_ms:.3f} ms per unprofiled step: idle share "
          f"{max(0.0, 1 - busy / step_ms):.4f}", flush=True)
    for ms, calls, name in kernels[:14]:
        print(f"train profile:   {ms:8.3f} ms/step {100 * ms / busy:5.1f}% "
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


def grad_phase() -> None:
    """Phase 7: one step's trunk gradients, bf16 kernels vs f32 CPU plain."""
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
    print(f"grads: one step on 2 images, {len(names)} trunk tensors, bf16 "
          f"kernels on cuda vs f32 plain on the CPU: rel L2 {rel:.4g} "
          f"(bound {TRAIN_GRAD_REL_L2}); by group: {parts}", flush=True)
    if not rel <= TRAIN_GRAD_REL_L2:
        raise AssertionError(f"grads: rel L2 {rel} > {TRAIN_GRAD_REL_L2}")


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
        launches = serve_phase()
        for k, n in train_phase().items():
            launches[k] += n
        grad_phase()
        cli_phase(checkpoints_dir)
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
