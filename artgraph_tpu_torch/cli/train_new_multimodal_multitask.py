"""New-multimodal multi-task trainer on the GPU, the reference's best model
(new_multimodal_multitask_vit, BASELINE.md headline rows) — port of
artgraph_tpu/cli/train_new_multimodal_multitask.py.

Same flags as the reference's src/train_new_multimodal_multitask.py (the six
embedding files, --emb_type, --dropout, --architecture with `vit` the
default + the base arguments), plus `--device` (default `cuda`): it trains
with the TRUE KG embeddings and validates and tests with the PROJECTED
ones, with the 0.5/0.5 task loss (ref :79-81), Adam and patience 3:

    python -m artgraph_tpu_torch.cli.train_new_multimodal_multitask \
        --dataset_path <dataset> --image_path <images> --emb_type artwork \
        --emb_train_style <f> --emb_valid_style <f> --emb_test_style <f> \
        --emb_train_genre <f> --emb_valid_genre <f> --emb_test_genre <f>

The embeddings are read from <dataset>/{train,validation,test}/embeddings/.
`--architecture vit` trains NewMultiModalMultiTaskViT, anything else
NewMultiModalMultiTask (ResNet50). The reference's test() always rebuilds
the ResNet variant (ref :131); as the JAX package, the port reloads the
architecture that was trained (PARITY.md deviation 3). The test split
writes results_style*.csv and results_genre*.csv with --results_dir.
"""
from __future__ import annotations

import os

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (
    evaluate_single_task, get_base_arguments, launch_ranks, log_test_metric,
    make_loaders, make_mesh, maybe_warm_start, multi_task_loss, needs_launch,
    reload_state, resolve_device, run_epoch_loop, save_checkpoint)
from artgraph_tpu_torch.data.factories import (
    get_class_weights, load_dataset_multitask_new_multimodal)
from artgraph_tpu_torch.models import (NewMultiModalMultiTask,
                                       NewMultiModalMultiTaskViT)
from artgraph_tpu_torch.tracking import tracker_multitask
from artgraph_tpu_torch.train import EarlyStopping
from artgraph_tpu_torch.train.trainer import Trainer, adam

NUM_CLASSES = config.NUM_CLASSES


def image_and_embeddings(img, batch):
    """forward_inputs of the fusion models; batch (img, emb_style,
    emb_genre, labels [B, 2], mask)."""
    return img, batch[1], batch[2]


def main(argv=None):
    parser = get_base_arguments()
    parser.add_argument('--emb_desc', type=str,
                        default='new multimodal multitask',
                        help='Experiment description.')
    parser.add_argument('--emb_type', type=str, default='genre',
                        help='Embedding type (artwork|genre|style).')
    parser.add_argument('--emb_train_genre', type=str,
                        default='gnn_genre_embs_graph.pt',
                        help='Embedding genre train file name.')
    parser.add_argument('--emb_valid_genre', type=str,
                        default='gnn_genre_valid_embs_graph.pt',
                        help='Embedding genre valid file name.')
    parser.add_argument('--emb_test_genre', type=str,
                        default='gnn_genre_test_embs_graph.pt',
                        help='Embedding genre test file name.')
    parser.add_argument('--emb_train_style', type=str,
                        default='gnn_style_embs_graph.pt',
                        help='Embedding style train file name.')
    parser.add_argument('--emb_valid_style', type=str,
                        default='gnn_style_valid_embs_graph.pt',
                        help='Embedding style valid file name.')
    parser.add_argument('--emb_test_style', type=str,
                        default='gnn_style_test_embs_graph.pt',
                        help='Embedding style test file name.')
    parser.add_argument('--dropout', type=float, default=0.4, help='Dropout.')
    parser.add_argument('--architecture', type=str, default='vit',
                        help='Architecture (resnet|vit).')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if needs_launch(args):
        return launch_ranks(args, main, argv)
    mesh = make_mesh(args)

    dataset_train, dataset_valid, dataset_test = \
        load_dataset_multitask_new_multimodal(
            base_dir=args.dataset_path, image_dir=args.image_path,
            emb_type=args.emb_type,
            emb_train={'style': args.emb_train_style,
                       'genre': args.emb_train_genre},
            emb_valid={'style': args.emb_valid_style,
                       'genre': args.emb_valid_genre},
            emb_test={'style': args.emb_test_style,
                      'genre': args.emb_test_genre},
            transform_type=args.architecture)
    loaders = make_loaders({'train': dataset_train, 'valid': dataset_valid,
                            'test': dataset_test}, args.batch,
                            args.num_workers, cache_dir=args.image_cache,
                            resident=args.resident_data,
                            epoch_scan=not args.no_epoch_scan, device=device,
                            mesh=mesh)

    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model = (NewMultiModalMultiTask if args.architecture == 'resnet'
             else NewMultiModalMultiTaskViT)(
        emb_size=config.EMB_SIZE, num_classes=NUM_CLASSES,
        dropout=args.dropout)
    if args.with_weights:
        cw_s = get_class_weights(dataset_train, NUM_CLASSES['style'], 'style')
        cw_g = get_class_weights(dataset_train, NUM_CLASSES['genre'], 'genre')
    else:
        cw_s = cw_g = None
    trainer = Trainer(model=model, optimizer=adam(args.lr),
                      compute_loss=multi_task_loss(cw_s, cw_g, 0.5, 0.5,
                                                   device),
                      transform_type=args.architecture, device=device,
                      seed=config.GLOBAL_SEED, mesh=mesh,
                      forward_inputs=image_and_embeddings)
    maybe_warm_start(args, trainer, type(model).__name__)

    checkpoint_name = os.path.join(config.CHECKPOINTS_DIR,
                                   'new-multimodal_multi-task_checkpoint.pt')
    early_stop = EarlyStopping(patience=3, min_delta=0.001,
                               checkpoint_path=checkpoint_name,
                               save_fn=save_checkpoint)

    @tracker_multitask(args.tracking, 'train')
    def train(epoch):
        m = trainer.train_epoch(loaders['train'])
        print(f'Train loss: {m["loss"]}; train style accuracy: '
              f'{m["style_correct"]}; train genre accuracy '
              f'{m["genre_correct"]}')
        return m['loss'], m['style_correct'], m['genre_correct'], epoch

    @tracker_multitask(args.tracking, 'valid')
    def valid(epoch):
        m = trainer.eval_epoch(loaders['valid'])
        early_stop(m['loss'], trainer.model)
        print(f'Validation loss: {m["loss"]}; validation style accuracy: '
              f'{m["style_correct"]}; validation genre accuracy '
              f'{m["genre_correct"]}')
        return m['loss'], m['style_correct'], m['genre_correct'], epoch

    run_epoch_loop(args, trainer, (loaders['train'], loaders['valid']),
                   early_stop, train, valid)

    reload_state(trainer, checkpoint_name)
    style_acc = evaluate_single_task(trainer, loaders['test'],
                                     NUM_CLASSES['style'], args.results_dir,
                                     output_index=0, suffix='_style')
    genre_acc = evaluate_single_task(trainer, loaders['test'],
                                     NUM_CLASSES['genre'], args.results_dir,
                                     output_index=1, suffix='_genre')
    print(f'Test style accuracy: {style_acc}; test genre accuracy: '
          f'{genre_acc}')
    log_test_metric(args, 'test style acc', style_acc)
    log_test_metric(args, 'test genre acc', genre_acc)
    return style_acc, genre_acc


if __name__ == '__main__':
    main()
