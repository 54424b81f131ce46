"""Batched inference CLI on the GPU — port of artgraph_tpu/cli/predict.py.

Loads a reference-format .pt checkpoint of one of the eight models (four on
the ViT-B/16 trunk, four on ResNet50) and classifies images, with the JAX
CLI's flags, output rows and CSV schema, plus `--device` (default `cuda`):

    python -m artgraph_tpu_torch.cli.predict \
        --checkpoint checkpoints/style_vit_single-task_checkpoint.pt \
        --model ViTSingleTask --label style \
        --images path/to/dir_or_files... [--top_k 3] [--output preds.csv]

For the fusion models (NewMultiModal*), pass --emb_style/--emb_genre .pt (or
.npy) files with row-aligned projected embeddings. Batches are padded to
--batch, as the JAX CLI pads them to one static shape. On `cuda` every batch
runs the normalize kernel and, for the ViT models, in each of the 12 blocks,
the block attention and block MLP kernels; the ResNet models run their
convolutions on cuDNN with BatchNorm's running statistics (the fused
conv + BN-statistics unit is a train-mode kernel). The CLI never moves to
the CPU on its own.

PIL (JPEG decode, data/transforms.py) and pandas (for --output) are imported
only where they are used, so the rest of the port runs on a host that has
neither.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from artgraph_tpu_torch import config, profiling
from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
from artgraph_tpu_torch.cli._common import resolve_device
from artgraph_tpu_torch.data.transforms import decode_resize_uint8
from artgraph_tpu_torch.ops import normalize_images

MODELS = {
    # name -> (transform_type, needs_embeddings, multi_task)
    "ResnetSingleTask": ("resnet", False, False),
    "ViTSingleTask": ("vit", False, False),
    "ResnetMultiTask": ("resnet", False, True),
    "ViTMultiTask": ("vit", False, True),
    "NewMultiModalSingleTask": ("resnet", True, False),
    "NewMultiModalSingleTaskVit": ("vit", True, False),
    "NewMultiModalMultiTask": ("resnet", True, True),
    "NewMultiModalMultiTaskViT": ("vit", True, True),
}


@torch.inference_mode()
def infer(model: torch.nn.Module, images_u8: torch.Tensor,
          *embs: torch.Tensor, transform_type: str = "vit"):
    """One serving batch: uint8 NHWC images -> normalize -> model logits,
    inside the span `ag.predict.infer` (profiling.py)."""
    with profiling.annotate("ag.predict.infer"):
        return model(normalize_images(images_u8, transform_type), *embs)


def load_embedding(path: str) -> np.ndarray:
    """A 2D float32 embedding matrix from .pt (torch) or .npy."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        arr = torch.load(path, map_location="cpu", weights_only=True).numpy()
    return np.ascontiguousarray(arr, dtype=np.float32)


def gather_images(paths):
    files = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.lower().endswith((".jpg", ".jpeg", ".png"))))
        else:
            files.append(p)
    return files


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--model", type=str, required=True,
                        choices=sorted(MODELS))
    parser.add_argument("--label", type=str, default="genre",
                        help="Task for single-task models (style|genre).")
    parser.add_argument("--images", type=str, nargs="+", required=True,
                        help="Image files and/or directories.")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--top_k", type=int, default=3)
    parser.add_argument("--emb_style", type=str, default=None,
                        help="Row-aligned style embeddings (.pt) for fusion models.")
    parser.add_argument("--emb_genre", type=str, default=None,
                        help="Row-aligned genre embeddings (.pt) for fusion models.")
    parser.add_argument("--output", type=str, default=None,
                        help="Write predictions CSV here (default: stdout JSON).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to serve on (cuda, cuda:N or cpu).")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    transform_type, needs_emb, multi_task = MODELS[args.model]

    emb_style = emb_genre = None
    if needs_emb:
        if multi_task:
            if not (args.emb_style and args.emb_genre):
                parser.error(f"{args.model} requires --emb_style and --emb_genre")
            emb_style = load_embedding(args.emb_style)
            emb_genre = load_embedding(args.emb_genre)
        else:
            src = args.emb_style if args.label == "style" else args.emb_genre
            if src is None:
                parser.error(f"{args.model} requires --emb_{args.label}")
            emb_style = load_embedding(src)

    files = gather_images(args.images)
    if not files:
        print("no images found", file=sys.stderr)
        return 1
    model = load_reference_checkpoint(args.model, args.checkpoint, device)

    batch = args.batch
    results = []
    for start in range(0, len(files), batch):
        chunk = files[start:start + batch]
        images = np.zeros((batch, config.IMAGE_SIZE, config.IMAGE_SIZE, 3),
                          dtype=np.uint8)
        for i, path in enumerate(chunk):
            images[i] = decode_resize_uint8(path)
        embs = ()
        if needs_emb:
            def rows(table):
                out = np.zeros((batch, table.shape[1]), np.float32)
                out[:len(chunk)] = table[start:start + len(chunk)]
                return torch.from_numpy(out).to(device)
            embs = ((rows(emb_style), rows(emb_genre)) if multi_task
                    else (rows(emb_style),))
        outputs = infer(model, torch.from_numpy(images).to(device), *embs,
                        transform_type=transform_type)
        outs = outputs if multi_task else [outputs]
        tasks = ["style", "genre"] if multi_task else [args.label]
        scores_by_task = [o.cpu().numpy() for o in outs]
        for i, path in enumerate(chunk):
            row = {"image": path}
            for task, scores in zip(tasks, scores_by_task):
                top = np.argsort(-scores[i])[:args.top_k]
                row[f"{task}_top{args.top_k}"] = top.tolist()
                row[f"{task}_pred"] = int(top[0])
            results.append(row)

    if args.output:
        import pandas as pd

        pd.DataFrame(results).to_csv(args.output, index=False)
        print(f"wrote {len(results)} predictions to {args.output}")
    else:
        for row in results:
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
