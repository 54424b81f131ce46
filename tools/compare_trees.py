#!/usr/bin/env python3
"""Time the port's kernels and ViT-B/16 serving from one source tree.

    python3 tools/compare_trees.py <tree> [--phases]   # on a machine with a GPU
    python3 tools/compare_trees.py <tree> --csr-normalize

<tree> is the root of a checkout (this repo, or an older commit unpacked
with `git archive` into a gitignored directory). The script imports the port
from that tree, builds its kernels there, and prints, for B=32, N=197,
C=768, H=12, MLP 3072, bf16 (ms: median of 10 CUDA-event timings of 10
calls, under inference_mode):

  * ms per call of fused_block_attention and fused_block_mlp (rows 1, 2) and
    serving img/s of ViTSingleTask over 10 batches (host clock, ending in a
    synchronize);
  * ms per call of the block backwards (rows 1b, 2b), of
    fused_qkv_attention forward and backward (rows 5, 5b), and of each
    ViT-B/16 call of the block GEMM through gemm_cuda (the products of rows
    1, 1b, 2, 2b, 5, 5b) with its TFLOP/s;
  * ms per call of the fused 1x1-conv + BN-statistics unit, forward and
    backward (rows 10, 10b), at the three ResNet50 shapes of chip_smoke.py;
  * the device time per call of each kernel the two block forwards launch
    (torch.profiler over 10 calls), and the host time the profiler saw.

With --phases it then runs that tree's own chip_smoke.py phases 5, 6, 13,
16, 17 and 18 (serve_phase, train_phase, resnet_train_phase,
vit_unfused_serve_phase, vit_unfused_train_phase, attention_module_phase),
with TF32 off and the checkpoints in a temporary directory, as its main()
runs them.

With --csr-normalize it runs only two phases of THIS checkout's
chip_smoke.py against the tree's port (loaded by path, so the measuring
code is the same for both trees): the device-time sub-phase of rows 9 and 3
(scalar_normalize_phases: the CSR scalar sum at three E = 1M shapes, the
uint8 normalize at [32, 224, 224, 3]) and phase 9 (gnn_train_phase, whose
profile prints the scalar sum's device time a GNN step). They call only
what every tree since the GNN slice has.

It calls only functions that every tree since the first ResNet slice has
(the block ops and their `*_cuda` backwards, `gemm_cuda`,
`fused_qkv_attention_cuda` and its backward, `conv1x1_bn_stats_cuda` and
its backward), so two trees compare line by line. They compare only within
one machine: run them in turns in one command (A, B, B, A), as in

    for t in build/parent . . build/parent; do python3 tools/compare_trees.py $t --phases; done
"""
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B, N, C, H, HIDDEN = 32, 197, 768, 12, 3072
M = B * N
# the ViT-B/16 GEMM calls: (what, layout, epilogue, M, N, K) with the
# layouts and epilogues of ops/attention.py (NT 0, NN 1, TN 2; EPI_BIAS 0,
# _GELU 1, _RESIDUAL 2, _GELU_AUX 3, EPI_NONE 4, EPI_F32 5, EPI_DGELU 6)
GEMMS = (
    ("qkv", 0, 0, M, 3 * C, C), ("proj", 0, 2, M, C, C),
    ("fc1", 0, 1, M, HIDDEN, C), ("fc1 recompute", 0, 3, M, HIDDEN, C),
    ("fc2", 0, 2, M, C, HIDDEN), ("do.W_proj", 1, 4, M, C, C),
    ("dqkv.W_qkv", 1, 5, M, C, 3 * C), ("do.W2", 1, 6, M, HIDDEN, C),
    ("dh.W1", 1, 5, M, C, HIDDEN), ("dW_qkv", 2, 5, 3 * C, C, M),
    ("dW_proj", 2, 5, C, C, M), ("dW1", 2, 5, HIDDEN, C, M),
    ("dW2", 2, 5, C, HIDDEN, M))
# (M, K, N, prologue) of the conv + BN-statistics unit (chip_smoke.py)
CONV_BN_SHAPES = ((100352, 64, 256, True), (6272, 1024, 256, False),
                  (1568, 512, 2048, True))


def _time_ms(fn, timings: int = 10, reps: int = 10) -> float:
    for _ in range(3):
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


PHASES = ("serve_phase", "train_phase", "resnet_train_phase",
          "vit_unfused_serve_phase", "vit_unfused_train_phase",
          "attention_module_phase")


def csr_normalize(tree: str) -> None:
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here",
        Path(__file__).resolve().parents[1] / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from artgraph_tpu_torch import ops

    print(f"{tree}: port from {ops.__file__}", flush=True)
    for name in ("scalar_normalize_phases", "gnn_train_phase"):
        print(f"{tree}: chip_smoke.{name} (this checkout's)", flush=True)
        getattr(here, name)()


def main(tree: str, phases: bool, csr_norm: bool = False) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("compare_trees: needs an NVIDIA GPU")
    sys.path.insert(0, tree)
    if csr_norm:
        csr_normalize(tree)
        return 0
    checkpoints = tempfile.mkdtemp(prefix="compare_trees_ckpt_")
    # read by the port's config when it is first imported
    os.environ["ARTGRAPH_CHECKPOINTS_DIR"] = checkpoints
    try:
        kernels(tree)
        if phases:
            import chip_smoke            # the tree's own, first on the path

            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            for name in PHASES:
                print(f"{tree}: chip_smoke.{name}", flush=True)
                getattr(chip_smoke, name)()
    finally:
        shutil.rmtree(checkpoints, ignore_errors=True)
    return 0


def kernels(tree: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from artgraph_tpu_torch import ops
    from artgraph_tpu_torch.cli.predict import infer
    from artgraph_tpu_torch.models import ViTSingleTask, init_random_
    from artgraph_tpu_torch.ops import attention, conv_bn, mlp

    print(f"{tree}: port from {ops.__file__}", flush=True)
    rng = np.random.default_rng(0)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    def block_params(out1, in2):
        return [dev(1 + 0.1 * rng.normal(size=C)),
                dev(0.1 * rng.normal(size=C)),
                dev(rng.normal(size=(out1, C)) / np.sqrt(C)),
                dev(0.02 * rng.normal(size=out1)),
                dev(rng.normal(size=(C, in2)) / np.sqrt(in2)),
                dev(0.02 * rng.normal(size=C))]

    x = dev(rng.normal(size=(B, N, C)), torch.bfloat16)
    do = dev(rng.normal(size=(B, N, C)), torch.bfloat16)
    attn_p, mlp_p = block_params(3 * C, C), block_params(HIDDEN, HIDDEN)
    blocks = {"attn": lambda: ops.fused_block_attention(x, *attn_p, H),
              "mlp": lambda: ops.fused_block_mlp(x, *mlp_p)}
    with torch.inference_mode():
        ms = {name: _time_ms(fn) for name, fn in blocks.items()}
    model = init_random_(ViTSingleTask(32),
                         torch.Generator().manual_seed(0)).cuda().eval()
    images = torch.from_numpy(rng.integers(0, 256, (B, 224, 224, 3),
                                           dtype=np.uint8)).cuda()
    infer(model, images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        infer(model, images)
    torch.cuda.synchronize()
    img_s = 10 * B / (time.perf_counter() - t0)
    print(f"{tree}: attn {ms['attn']:.4f} ms, mlp {ms['mlp']:.4f} ms, "
          f"serve {img_s:.1f} img/s", flush=True)
    del model, images

    w_qkv, b_qkv = attn_p[2], attn_p[3]
    xout = attention.fused_qkv_attention_cuda(x, w_qkv, b_qkv, H)
    rows = {
        "attn_bwd (1b)": lambda: attention.block_attention_bwd_cuda(
            x, *attn_p, do, H, 1e-6),
        "mlp_bwd (2b)": lambda: mlp.block_mlp_bwd_cuda(x, *mlp_p, do, 1e-6),
        "qkv_attention (5)": lambda: attention.fused_qkv_attention_cuda(
            x, w_qkv, b_qkv, H),
        "qkv_attention_bwd (5b)":
            lambda: attention.fused_qkv_attention_bwd_cuda(
                x, w_qkv, b_qkv, xout, do, H),
    }
    with torch.inference_mode():
        for name, fn in rows.items():
            print(f"{tree}: {name} {_time_ms(fn):.4f} ms", flush=True)
        for what, layout, epi, m, n, k in GEMMS:
            a = dev(rng.normal(size=(k, m) if layout == 2 else (m, k)),
                    torch.bfloat16)
            b = dev(rng.normal(size=(n, k) if layout == 0 else (k, n))
                    / np.sqrt(k), torch.bfloat16)
            bias = dev(0.02 * rng.normal(size=n)) if epi <= 3 else None
            aux = (dev(rng.normal(size=(m, n)), torch.bfloat16)
                   if epi in (2, 6) else None)
            t = _time_ms(lambda: attention.gemm_cuda(a, b, layout, epi,
                                                     bias=bias, aux=aux))
            print(f"{tree}: gemm {what} M={m} N={n} K={k} {t:.4f} ms "
                  f"{2 * m * n * k / t / 1e9:.1f} TFLOP/s", flush=True)
            del a, b, bias, aux
        for Mu, K, Nu, pro in CONV_BN_SHAPES:
            xu = dev(rng.normal(size=(Mu, K)), torch.bfloat16)
            a = dev(1.0 + 0.2 * rng.normal(size=K), torch.bfloat16)
            b = dev(0.1 * rng.normal(size=K), torch.bfloat16)
            w = dev(rng.normal(size=(Nu, K)) / np.sqrt(K))
            dy = dev(rng.normal(size=(Mu, Nu)), torch.bfloat16)
            ds1 = dev(1e-3 * np.sqrt(Mu) * rng.normal(size=Nu))
            ds2 = dev(1e-4 * np.sqrt(Mu) * rng.normal(size=Nu))
            y = conv_bn.conv1x1_bn_stats_cuda(xu, a, b, w, pro)[0]
            fwd = _time_ms(lambda: conv_bn.conv1x1_bn_stats_cuda(xu, a, b, w,
                                                                 pro))
            bwd = _time_ms(lambda: conv_bn.conv1x1_bn_stats_bwd_cuda(
                xu, a, b, w, y, dy, ds1, ds2, pro))
            print(f"{tree}: conv_bn M={Mu} K={K} N={Nu} prologue={pro} fwd "
                  f"(10) {fwd:.4f} ms, bwd (10b) {bwd:.4f} ms", flush=True)
            del xu, a, b, w, dy, y
        torch.cuda.empty_cache()

    with torch.inference_mode():
        for name, fn in blocks.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
            for e in sorted((e for e in events
                             if e.device_type == DeviceType.CUDA),
                            key=lambda e: -e.self_device_time_total):
                print(f"{tree}: {name} device "
                      f"{e.self_device_time_total / 10 / 1e3:.4f} ms "
                      f"x{e.count // 10} {e.key[:70]}")
            host = sum(e.self_cpu_time_total for e in events
                       if e.device_type == DeviceType.CPU) / 10 / 1e3
            print(f"{tree}: {name} host {host:.4f} ms per call under the "
                  f"profiler", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(next((a for a in args if not a.startswith("--")), "."),
                  "--phases" in args, "--csr-normalize" in args))
