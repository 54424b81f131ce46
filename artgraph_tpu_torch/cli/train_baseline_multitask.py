"""Image-only multi-task baseline trainer (style and genre heads) on the GPU
— port of artgraph_tpu/cli/train_baseline_multitask.py.

Same flags as the reference's src/train_baseline_multitask.py
(--architecture, --dropout + the base arguments), checkpoint name (with the
reference's literal 'single-task' in it), patience (3), loss
(0.6 * CE_style + 0.4 * CE_genre, optional class weights), Adam and prints,
plus `--device` (default `cuda`):

    python -m artgraph_tpu_torch.cli.train_baseline_multitask \
        --architecture resnet --dataset_path <dataset> --image_path <images>

`--architecture resnet` (the default) trains ResnetMultiTask, anything else
ViTMultiTask, as the JAX CLI does. On `cuda` every step runs the normalize
kernel; the ViT runs the block attention and block MLP kernels in each of
its 12 blocks forward and backward; ResNet50 runs cuDNN convolutions and,
with ARTGRAPH_CONVBN=1, the fused 1x1-conv + BN-statistics unit on full
train batches. The test split writes results_style*.csv and
results_genre*.csv with --results_dir.
"""
from __future__ import annotations

import os

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (
    evaluate_single_task, get_base_arguments, launch_ranks, log_test_metric,
    make_loaders, make_mesh, maybe_warm_start, multi_task_loss, needs_launch,
    reload_state, resolve_device, run_epoch_loop, save_checkpoint)
from artgraph_tpu_torch.data.factories import get_class_weights, load_dataset
from artgraph_tpu_torch.models import ResnetMultiTask, ViTMultiTask
from artgraph_tpu_torch.tracking import tracker_multitask
from artgraph_tpu_torch.train import EarlyStopping
from artgraph_tpu_torch.train.trainer import Trainer, adam

NUM_CLASSES = config.NUM_CLASSES


def main(argv=None):
    parser = get_base_arguments()
    parser.add_argument('--architecture', type=str, default='resnet',
                        help='Architecture (vit|resnet).')
    parser.add_argument('--dropout', type=float, default=0.4, help='Dropout.')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if needs_launch(args):
        return launch_ranks(args, main, argv)
    mesh = make_mesh(args)
    print(args)

    dataset_train, dataset_valid, dataset_test = load_dataset(
        base_dir=args.dataset_path, image_dir=args.image_path,
        mode='multi_task', transform_type=args.architecture)
    loaders = make_loaders({'train': dataset_train, 'valid': dataset_valid,
                            'test': dataset_test}, args.batch,
                            args.num_workers, cache_dir=args.image_cache,
                            resident=args.resident_data,
                            epoch_scan=not args.no_epoch_scan, device=device,
                            mesh=mesh)

    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model = (ResnetMultiTask if args.architecture == 'resnet'
             else ViTMultiTask)(NUM_CLASSES, args.dropout)
    if args.with_weights:
        cw_s = get_class_weights(dataset_train, NUM_CLASSES['style'], 'style')
        cw_g = get_class_weights(dataset_train, NUM_CLASSES['genre'], 'genre')
    else:
        cw_s = cw_g = None
    trainer = Trainer(model=model, optimizer=adam(args.lr),
                      compute_loss=multi_task_loss(cw_s, cw_g, 0.6, 0.4,
                                                   device),
                      transform_type=args.architecture, device=device,
                      seed=config.GLOBAL_SEED, mesh=mesh)
    maybe_warm_start(args, trainer, type(model).__name__)

    # the reference keeps 'single-task' in this checkpoint name (ref :48)
    checkpoint_name = os.path.join(
        config.CHECKPOINTS_DIR,
        f'{args.architecture}_baseline_single-task_checkpoint.pt')
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
