"""ContextNet / MultiModal ("sansaro") multi-task context trainer on the GPU
— port of artgraph_tpu/cli/train_baseline_context_multitask.py.

Same flags as the reference's src/train_baseline_context_multitask.py
(--net, --emb_type, --emb_train with its default
node2vec_artwork_embs_graph.pt + the base arguments), checkpoint name,
patience (1) and prints, plus `--device` (default `cuda`):

    python -m artgraph_tpu_torch.cli.train_baseline_context_multitask \
        --net multi-modal --dataset_path <dataset> --image_path <images> \
        --emb_train <file in <dataset>/train/embeddings/>

The train loss is lamb * (0.5 * CE_style + 0.5 * CE_genre) + (1 - lamb) *
encoder_loss(graph_proj, embedding) (ref :78-81), with the encoder loss,
optimizer and lamb of train_baseline_context's --net. Valid and test are
image-only; their loss is the 0.5/0.5 class loss. The reference's valid()
names an undefined `class_criterion` (a NameError if run); the port, as the
JAX package, uses the per-task criteria, the evident intent (PARITY.md
deviation 2). The embedding table has a row per train image. The test
split writes results_style*.csv and results_genre*.csv with --results_dir.
"""
from __future__ import annotations

import os

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (
    evaluate_single_task, get_base_arguments, joint_loss, launch_ranks,
    log_test_metric, logits_loss, make_loaders, make_mesh, maybe_warm_start,
    multi_task_loss, needs_launch, reload_state, resolve_device,
    run_epoch_loop, save_checkpoint)
from artgraph_tpu_torch.cli.train_baseline_context import net_recipe
from artgraph_tpu_torch.data.factories import (get_class_weights,
                                               load_dataset_multimodal)
from artgraph_tpu_torch.models import ContextNetlMultiTask, MultiModalMultiTask
from artgraph_tpu_torch.tracking import tracker_multitask
from artgraph_tpu_torch.train import EarlyStopping
from artgraph_tpu_torch.train.trainer import Trainer

NUM_CLASSES = config.NUM_CLASSES
NETS = {'context-net': ContextNetlMultiTask,
        'multi-modal': MultiModalMultiTask}


def main(argv=None):
    parser = get_base_arguments()
    parser.add_argument('--net', type=str, default='multi-modal',
                        help='The architecture. Options: (context-net|multi-modal)')
    parser.add_argument('--emb_type', type=str, default='artwork',
                        help='Embedding type. Options: (artwork|style|genre).')
    parser.add_argument('--emb_train', type=str,
                        default='node2vec_artwork_embs_graph.pt',
                        help='Embedding train file.')
    args = parser.parse_args(argv)
    if args.net not in NETS:
        parser.error(f'--net {args.net!r}: options are {sorted(NETS)}')
    device = resolve_device(args.device)
    if needs_launch(args):
        return launch_ranks(args, main, argv)
    mesh = make_mesh(args)

    dataset_train, dataset_valid, dataset_test = load_dataset_multimodal(
        base_dir=args.dataset_path, image_dir=args.image_path,
        mode='multi_task', emb_type=args.emb_type, emb_train=args.emb_train)
    loaders = make_loaders({'train': dataset_train, 'valid': dataset_valid,
                            'test': dataset_test}, args.batch,
                            args.num_workers, cache_dir=args.image_cache,
                            resident=args.resident_data,
                            epoch_scan=not args.no_epoch_scan, device=device,
                            mesh=mesh)

    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model = NETS[args.net](emb_size=config.EMB_SIZE, num_classes=NUM_CLASSES)
    if args.with_weights:
        cw_s = get_class_weights(dataset_train, NUM_CLASSES['style'], 'style')
        cw_g = get_class_weights(dataset_train, NUM_CLASSES['genre'], 'genre')
    else:
        cw_s = cw_g = None
    class_loss = multi_task_loss(cw_s, cw_g, 0.5, 0.5, device)
    encoder_criterion, optimizer, lamb = net_recipe(args.net, args.lr)
    trainer = Trainer(model=model, optimizer=optimizer,
                      compute_loss=joint_loss(class_loss, encoder_criterion,
                                              lamb),
                      eval_compute_loss=logits_loss(class_loss),
                      transform_type='resnet', device=device,
                      seed=config.GLOBAL_SEED, mesh=mesh)
    maybe_warm_start(args, trainer, type(model).__name__)

    checkpoint_name = os.path.join(config.CHECKPOINTS_DIR,
                                   f'{args.net}_multi-task_checkpoint.pt')
    early_stop = EarlyStopping(patience=1, min_delta=0.001,
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
                                     output_index=(0, 0), suffix='_style')
    genre_acc = evaluate_single_task(trainer, loaders['test'],
                                     NUM_CLASSES['genre'], args.results_dir,
                                     output_index=(0, 1), suffix='_genre')
    print(f'Test style accuracy: {style_acc}; test genre accuracy: '
          f'{genre_acc}')
    log_test_metric(args, 'test style acc', style_acc)
    log_test_metric(args, 'test genre acc', genre_acc)
    return style_acc, genre_acc


if __name__ == '__main__':
    main()
