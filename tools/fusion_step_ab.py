#!/usr/bin/env python3
"""chip_smoke.py's phase 6 step (ViTSingleTask(32)) against its phase 19
step (NewMultiModalMultiTaskViT(128, style 32, genre 18)) on one card, in
turns: where the fusion step's extra time goes. With --context, phase 13's
gated ResnetSingleTask(32) step (A) against phase 21's ContextNetSingleTask
(B) and MultiModalMultiTask (C) steps, ARTGRAPH_CONVBN=1.

    python3 tools/fusion_step_ab.py [--context]   # from a checkout's root

Both models at full ViT-B/16 width with chip_smoke.py's seeds, batches (32
images), Trainer, adam(3e-4) and dropout 0.4, after 2 warm-up steps each.
Each round runs windows of 8 steps in the order A B Ad Bd Bd Ad B A, where
A is the ViT step and B the fusion step as the phases run them (the host
batch copied to the card inside each step) and Ad, Bd the same steps on a
batch already on the card (no H2D); with --context A B C Ad Bd Cd, then
the same reversed. For each window: ms a step by the host
clock ending in a synchronize. Then, for each model, one torch.profiler
session of 4 steps: the device's busy ms a step (kernels, memcpys and
memsets) and the host ops with the most self CPU time a step, and their
sum. Prints the card as nvidia-smi names it; needs CUDA.
"""
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
STEPS, ROUNDS, PROFILED = 8, 3, 4


def _trainers():
    """{label: (trainer, host batch)} for A (ViT) and B (fusion)."""
    import chip_smoke as cs
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli._common import (multi_task_loss,
                                                single_task_loss)
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.models import (NewMultiModalMultiTaskViT,
                                           ViTSingleTask, init_random_)
    from artgraph_tpu_torch.train import Trainer, adam

    rng = np.random.default_rng(cs.SEED + 2)
    vit_batch = (rng.integers(0, 256, (cs.B, 224, 224, 3), dtype=np.uint8),
                 rng.integers(0, 32, cs.B).astype(np.int32),
                 np.ones(cs.B, np.float32))
    vit = Trainer(init_random_(ViTSingleTask(32, dropout=0.4),
                               torch.Generator().manual_seed(cs.SEED + 10)),
                  adam(3e-4), single_task_loss(None), transform_type="vit",
                  device="cuda")
    fusion = Trainer(
        init_random_(NewMultiModalMultiTaskViT(config.EMB_SIZE,
                                               config.NUM_CLASSES,
                                               dropout=0.4),
                     torch.Generator().manual_seed(cs.SEED + 90)),
        adam(3e-4), multi_task_loss(None, None, 0.5, 0.5, "cuda"),
        transform_type="vit", device="cuda",
        forward_inputs=image_and_embeddings)
    return {"A": (vit, vit_batch),
            "B": (fusion, cs._fusion_batch(np.random.default_rng(cs.SEED + 90),
                                           cs.B))}


def _context_trainers():
    """{label: (trainer, host batch)} for A (phase 13's gated
    ResnetSingleTask), B and C (phase 21's context models), with the
    phases' seeds."""
    import chip_smoke as cs
    from artgraph_tpu_torch import config
    from artgraph_tpu_torch.cli._common import single_task_loss
    from artgraph_tpu_torch.models import ResnetSingleTask
    from artgraph_tpu_torch.train import Trainer, adam

    rng = np.random.default_rng(cs.SEED + 81)
    out = {"A": (Trainer(cs._seeded_resnet_(ResnetSingleTask(32, dropout=0.4),
                                            cs.SEED + 80),
                         adam(3e-4), single_task_loss(None),
                         transform_type="resnet", device="cuda"),
                 (rng.integers(0, 256, (cs.B, 224, 224, 3), dtype=np.uint8),
                  rng.integers(0, 32, cs.B).astype(np.int32),
                  np.ones(cs.B, np.float32)))}
    for i, (label, (_, build, optimizer, _, train_loss, _, labels_of)) in \
            enumerate(zip("BC", cs._context_nets())):
        seed = cs.SEED + 100 + 10 * i
        rng = np.random.default_rng(seed)
        out[label] = (
            Trainer(cs._seeded_resnet_(build(torch.bfloat16), seed),
                    optimizer, train_loss, transform_type="resnet",
                    device="cuda"),
            (rng.integers(0, 256, (cs.B, 224, 224, 3), dtype=np.uint8),
             rng.normal(size=(cs.B, config.EMB_SIZE)).astype(np.float32),
             labels_of(rng, cs.B), np.ones(cs.B, np.float32)))
    return out


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("fusion_step_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--context" in argv:
        os.environ["ARTGRAPH_CONVBN"] = "1"
        trainers = _context_trainers()
    else:
        trainers = _trainers()
    labels = list(trainers)
    order = labels + [label + "d" for label in labels]
    order += order[::-1]
    steps = {}
    for label, (trainer, batch) in trainers.items():
        trainer.model.train()
        on_card = trainer.to_device(batch)
        steps[label] = lambda t=trainer, b=batch: t.train_step(t.to_device(b))
        steps[label + "d"] = lambda t=trainer, b=on_card: t.train_step(b)
    for step in steps.values():
        for _ in range(2):
            step()
    torch.cuda.synchronize()

    ms = {k: [] for k in steps}
    for _ in range(ROUNDS):
        for label in order:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                steps[label]()
            torch.cuda.synchronize()
            ms[label].append(1e3 * (time.perf_counter() - t0) / STEPS)
    for label, values in ms.items():
        print(f"{label}: ms a step {statistics.median(values):.3f} (median "
              f"of {len(values)} windows of {STEPS}: "
              f"{[round(v, 3) for v in values]})", flush=True)

    from torch.profiler import ProfilerActivity, profile

    for label in labels:
        work, _ = cs._device_work(steps[label], PROFILED)
        busy = sum(v for v, _ in work.values())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(PROFILED):
                steps[label]()
            torch.cuda.synchronize()
        events = sorted(prof.key_averages(),
                        key=lambda e: -e.self_cpu_time_total)
        total = sum(e.self_cpu_time_total for e in events) / PROFILED / 1e3
        print(f"{label}: device busy {busy:.3f} ms a step; host self CPU "
              f"{total:.3f} ms a step in {sum(e.count for e in events) // PROFILED} "
              f"op calls", flush=True)
        for e in events[:12]:
            print(f"{label}:   {e.self_cpu_time_total / PROFILED / 1e3:8.3f} "
                  f"ms x{e.count // PROFILED:4d} {e.key[:80]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
