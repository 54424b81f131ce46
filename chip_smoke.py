#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ViT-B/16 serving path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

It imports nothing of JAX (only the jax-free `artgraph_tpu.config`) and no
PIL or pandas. Phases, each printing one line; any failure raises and exits
non-zero:

  1. device   the card (nvidia-smi name and power limit), torch/CUDA versions;
              no CUDA -> exit 1 before anything else
  2. build    nvcc-builds artgraph_tpu_torch/ops/csrc/*.cu into
              build/artgraph_tpu_torch/ and loads it
  3. check    each kernel against its plain PyTorch version on the card at the
              serving shapes (B=32, N=197, C=768, H=12, bf16; inputs from a
              numpy seed): block attention and block MLP at rtol = atol = 3e-2,
              the uint8 normalize bit-exact for both statistics
  4. time     each kernel and its plain version: median of 10 CUDA-event
              timings, each over 10 back-to-back calls, after warm-up
  5. serve    ViTSingleTask(32) and NewMultiModalMultiTaskViT(128, ...) at
              full ViT-B/16 width with seeded random weights, saved as
              reference .pt files and loaded back through
              load_reference_checkpoint; 3 batches of 32 uint8 images through
              cli.predict.infer on cuda. The launch counters, zeroed just
              before, must read 12*3, 12*3 and 3 per model; logits finite and,
              on 2 images, within relative L2 5e-2 of the f32 plain path on
              the CPU with the same weights (a bf16 residual stream over 12
              blocks); img/s printed.

Then one JSON line with the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The f32 plain references run with TF32 off for matmuls and cuDNN.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
B, N, C, H, HIDDEN = 32, 197, 768, 12, 3072
KERNEL_TOL = 3e-2          # bf16 bound of tests/test_mlp_kernel.py
E2E_REL_L2 = 5e-2
SEED = 0
BATCHES = 3


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


def kernel_phases() -> dict:
    """Phases 3 and 4: each kernel against its plain version, then timed."""
    from artgraph_tpu_torch import ops

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
    cases = {
        "fused_block_attention": (
            lambda: ops.fused_block_attention(x, *attn_p, H),
            lambda: ops.block_attention_plain(x, *attn_p, H),
            "artgraph_tpu_torch/ops/csrc/block_attention.cu",
            "artgraph_tpu/ops/attention.py:500"),
        "fused_block_mlp": (
            lambda: ops.fused_block_mlp(x, *mlp_p),
            lambda: ops.block_mlp_plain(x, *mlp_p),
            "artgraph_tpu_torch/ops/csrc/block_gemm.cu",
            "artgraph_tpu/ops/mlp.py:167"),
        "normalize_images": (
            lambda: ops.normalize_images(images, "vit"),
            lambda: ops.normalize_images_plain(images, "vit"),
            "artgraph_tpu_torch/ops/csrc/normalize.cu",
            "artgraph_tpu/ops/preprocess.py:79"),
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
            max_abs, ratio = _errors(ours, ref)
            nz = ref.float().abs() >= KERNEL_TOL
            max_rel = ((ours.float() - ref.float()).abs()[nz]
                       / ref.float().abs()[nz]).max().item()
            print(f"check: {name} [{B},{N},{C}] bf16 vs plain: max abs "
                  f"{max_abs:.4g}, max rel {max_rel:.4g} (|ref| >= "
                  f"{KERNEL_TOL}), worst err/(atol+rtol|ref|) {ratio:.4g}",
                  flush=True)
            if not (ratio <= 1.0 and torch.isfinite(ours.float()).all()):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version beyond rtol=atol={KERNEL_TOL}")
        results[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "max_abs_err": max_abs}
    for name, (kernel, plain, _, _) in cases.items():
        ms, plain_ms = _time_ms(kernel), _time_ms(plain)
        results[name].update(ms=ms, plain_ms=plain_ms)
        print(f"time: {name} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(median of 10 CUDA-event timings of 10 calls)", flush=True)
    return results


def serve_phase() -> dict:
    """Phase 5: both ViT-B/16 models through cli.predict.infer on cuda."""
    from artgraph_tpu import config
    from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
    from artgraph_tpu_torch.cli.predict import infer
    from artgraph_tpu_torch.models import (NewMultiModalMultiTaskViT,
                                           ViTSingleTask, init_random_)
    from artgraph_tpu_torch.ops import attention, mlp, preprocess

    counters = {"fused_block_attention": attention, "fused_block_mlp": mlp,
                "normalize_images": preprocess}
    expect = {"fused_block_attention": 12 * BATCHES,
              "fused_block_mlp": 12 * BATCHES, "normalize_images": BATCHES}
    launches = dict.fromkeys(counters, 0)
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

            for mod in counters.values():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            outs = [infer(model, *batch) for batch in batches]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {k: mod.LAUNCHES for k, mod in counters.items()}
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


def main() -> int:
    device_phase()
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    kernels = kernel_phases()
    launches = serve_phase()
    for name, n in launches.items():
        kernels[name]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
