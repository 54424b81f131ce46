"""Visual -> KG-embedding projector trainer (pipeline stage 2) on the GPU —
port of artgraph_tpu/cli/train_projector.py.

Same flags as the reference's src/train_projector.py (--node_embedding,
--emb_type, --architecture + the base arguments) plus `--device` (default
`cuda`): SmoothL1 + Adam on the seeded 80/10/10 split of the train set
(random_state=11, ref: utils.py:215-221), patience 1, the checkpoint
PROJECTIONS_DIR/{exp}_checkpoint_projector.pt, and the reference's prints
(loss only):

    python -m artgraph_tpu_torch.cli.train_projector --exp e2e \
        --dataset_path <dataset> --image_path <images> \
        --node_embedding gnn_artwork_genre_embs_graph.pt --emb_type artwork

The embedding table is read from config.EMBEDDINGS_DIR. `--architecture
resnet` (the default) trains LabelProjector, anything else
LabelProjectorVit; both normalize with the ResNet statistics, as the
reference does even for the ViT. generate_projections loads every file of
PROJECTIONS_DIR as the ResNet LabelProjector, so a ViT projector belongs in
a directory of its own.

`--init_checkpoint` warm-starts the projector as in the JAX CLI. `--resume`
is refused: this trainer has no resumable epoch loop (the JAX CLI parses
the flag and ignores it). With `-t` the arguments and the epochs' `train
loss` and `valid loss` and the `test loss` are logged (the JAX CLI parses
the flag and logs nothing).
"""
from __future__ import annotations

import os

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (
    get_base_arguments, launch_ranks, make_loaders, make_mesh,
    maybe_warm_start, needs_launch, reload_state, resolve_device,
    save_checkpoint)
from artgraph_tpu_torch.data.factories import load_dataset_projection
from artgraph_tpu_torch.models import LabelProjector, LabelProjectorVit
from artgraph_tpu_torch.tracking import log_metric, track_params
from artgraph_tpu_torch.train import EarlyStopping, smooth_l1
from artgraph_tpu_torch.train.trainer import Trainer, adam


def projection_loss(outputs, batch):
    """SmoothL1 between the projection and the KG embedding over the valid
    rows; batch (img, embedding, mask)."""
    _, embeddings, mask = batch
    return smooth_l1(outputs, embeddings, mask=mask), {}


def main(argv=None):
    parser = get_base_arguments()
    parser.add_argument('--node_embedding', type=str,
                        default='gnn_artwork_genre_embs_graph.pt',
                        help='Node embedding file name.')
    parser.add_argument('--emb_type', type=str, default='artwork',
                        help='The embedding node type (artwork|style|genre).')
    parser.add_argument('--architecture', type=str, default='resnet',
                        help='Architecture (vt|resnet).')
    args = parser.parse_args(argv)
    if args.resume:
        parser.error('--resume: train_projector has no resumable epoch loop '
                     '(the JAX CLI parses the flag and ignores it)')
    device = resolve_device(args.device)
    if needs_launch(args):
        return launch_ranks(args, main, argv)
    mesh = make_mesh(args)

    dataset_train, dataset_valid, dataset_test = load_dataset_projection(
        base_dir=args.dataset_path, image_dir=args.image_path,
        node_embedding=args.node_embedding, emb_type=args.emb_type)
    loaders = make_loaders({'train': dataset_train, 'valid': dataset_valid,
                            'test': dataset_test}, args.batch,
                            args.num_workers, cache_dir=args.image_cache,
                            resident=args.resident_data,
                            epoch_scan=not args.no_epoch_scan, device=device,
                            mesh=mesh)

    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model = (LabelProjector if args.architecture == 'resnet'
             else LabelProjectorVit)(emb_size=config.EMB_SIZE)
    # the reference normalizes with the ResNet statistics for both
    trainer = Trainer(model=model, optimizer=adam(args.lr),
                      compute_loss=projection_loss, transform_type='resnet',
                      device=device, seed=config.GLOBAL_SEED, mesh=mesh)
    maybe_warm_start(args, trainer, type(model).__name__)

    checkpoint_path = os.path.join(config.PROJECTIONS_DIR,
                                   f'{args.exp}_checkpoint_projector.pt')
    early_stop = EarlyStopping(patience=1, min_delta=0.001,
                               checkpoint_path=checkpoint_path,
                               save_fn=save_checkpoint)

    if args.tracking:
        track_params(args)
    for epoch in range(args.epochs):
        m = trainer.train_epoch(loaders['train'])
        print(f'Train loss: {m["loss"]}')
        if args.tracking:
            log_metric('train loss', m['loss'], step=epoch)
        m = trainer.eval_epoch(loaders['valid'])
        early_stop(m['loss'], trainer.model)
        print(f'Validation loss: {m["loss"]}')
        if args.tracking:
            log_metric('valid loss', m['loss'], step=epoch)

    reload_state(trainer, checkpoint_path)
    m = trainer.eval_epoch(loaders['test'])
    print(f'Test loss: {m["loss"]}')
    if args.tracking:
        log_metric('test loss', m['loss'])
    return m['loss']


if __name__ == '__main__':
    main()
