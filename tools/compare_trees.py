#!/usr/bin/env python3
"""Time the port's block forwards and ViT-B/16 serving from one source tree.

    python3 tools/compare_trees.py <tree>     # on a machine with a GPU

<tree> is the root of a checkout (this repo, or an older commit unpacked
with `git archive` into a gitignored directory). The script imports the port
from that tree, builds its kernels there, and prints, for B=32, N=197,
C=768, H=12, MLP 3072, bf16:

  * ms per call of fused_block_attention and fused_block_mlp (median of 10
    CUDA-event timings of 10 calls, under inference_mode) and serving img/s
    of ViTSingleTask over 10 batches (host clock, ending in a synchronize);
  * the device time per call of each kernel the two block forwards launch
    (torch.profiler over 10 calls), and the host time the profiler saw.

Two trees compare only within one machine: run them in turns in one command
(A, B, B, A), as in

    for t in build/parent . . build/parent; do python3 tools/compare_trees.py $t; done
"""
import sys
import time

import numpy as np
import torch

B, N, C, H, HIDDEN = 32, 197, 768, 12, 3072


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


def main(tree: str) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("compare_trees: needs an NVIDIA GPU")
    sys.path.insert(0, tree)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from artgraph_tpu_torch import ops
    from artgraph_tpu_torch.cli.predict import infer
    from artgraph_tpu_torch.models import ViTSingleTask, init_random_

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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
