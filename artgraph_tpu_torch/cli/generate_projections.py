"""Projected KG embeddings of the validation and test artworks (pipeline
stage 3) on the GPU — port of artgraph_tpu/cli/generate_projections.py.

As the reference's src/generate_projections.py: for every file in
config.PROJECTIONS_DIR, load it as a LabelProjector (always the ResNet
variant, ref :30, so a ViT projector must live elsewhere), run an
order-preserving (shuffle=False) pass over the validation and test splits
of config.DATASET_DIR, and save row-aligned [N, 128] f32 tensors to
<dataset>/{validation,test}/embeddings/<file name> in the reference .pt
format. The reference takes no flags; the port adds `--device` (default
`cuda`):

    python -m artgraph_tpu_torch.cli.generate_projections --device cuda

Each batch runs the normalize kernel (ResNet statistics) and the projector
in eval mode.
"""
from __future__ import annotations

import argparse
from os import listdir
from os.path import isfile, join

import numpy as np
import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import load_reference_checkpoint
from artgraph_tpu_torch.cli._common import resolve_device
from artgraph_tpu_torch.cli.predict import infer
from artgraph_tpu_torch.data.datasets import ArtGraphSingleTask
from artgraph_tpu_torch.data.embeddings import save_embedding
from artgraph_tpu_torch.data.loader import DataLoader
from artgraph_tpu_torch.data.manifest import prepare_raw_dataset


def load_dataset(base_dir: str, image_dir: str):
    """The validation and test images, in manifest order."""
    return tuple(
        ArtGraphSingleTask(image_dir, prepare_raw_dataset(base_dir, type=split)[
            ['image', 'style', 'genre']])
        for split in ('validation', 'test'))


@torch.inference_mode()
def generate(projections_dir: str = None, dataset_dir: str = None,
             image_dir: str = None, batch_size: int = 32,
             num_workers: int = 6, device: str | torch.device = 'cuda'
             ) -> None:
    """Write every projector's valid/test projections; the directories
    default to config's, read at call time."""
    projections_dir = projections_dir or config.PROJECTIONS_DIR
    dataset_dir = dataset_dir or config.DATASET_DIR
    image_dir = image_dir or config.IMAGE_DIR

    proj_names = [f for f in listdir(projections_dir)
                  if isfile(join(projections_dir, f))]
    dataset_valid, dataset_test = load_dataset(dataset_dir, image_dir)

    for proj_name in proj_names:
        model = load_reference_checkpoint(
            'LabelProjector', join(projections_dir, proj_name), device)
        for split, dataset in (('validation', dataset_valid),
                               ('test', dataset_test)):
            loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                                drop_last=False, num_workers=num_workers)
            out = np.zeros((len(dataset), config.EMB_SIZE), dtype=np.float32)
            print(f'Generating projections for {split} artworks...')
            row = 0
            for images, _, mask in loader:
                n = int(mask.sum())
                emb = infer(model, torch.from_numpy(images).to(device),
                            transform_type='resnet')
                out[row:row + n] = emb[:n].cpu().numpy()
                row += n
            save_embedding(join(dataset_dir, split, 'embeddings', proj_name),
                           out)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='Torch device to run on (cuda, cuda:N or cpu).')
    args = parser.parse_args(argv)
    generate(device=resolve_device(args.device))


if __name__ == '__main__':
    main()
