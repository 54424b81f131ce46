"""ContextNet / MultiModal ("sansaro") single-task context trainer on the
GPU — port of artgraph_tpu/cli/train_baseline_context.py.

Same flags as the reference's src/train_baseline_context.py (--net,
--label, --emb_type, --emb_train + the base arguments), checkpoint name,
patience (1) and prints, plus `--device` (default `cuda`):

    python -m artgraph_tpu_torch.cli.train_baseline_context \
        --net multi-modal --dataset_path <dataset> --image_path <images> \
        --label genre --emb_train <file in <dataset>/train/embeddings/>

The train loss is lamb * CE + (1 - lamb) * encoder_loss(graph_proj,
embedding), where
  context-net: ContextNetSingleTask, SmoothL1, SGD (momentum 0.9), lamb 0.9
  multi-modal: MultiModalSingleTask, MSE, Adam, lamb 0.6
(ref :47-54). Training reads (image, embedding, label) batches; valid and
test are image-only and their loss is the cross-entropy alone, since the
logits need no embedding. Every split uses the ResNet transform. On `cuda`
each step runs the normalize kernel and, with ARTGRAPH_CONVBN=1, the fused
1x1-conv + BN-statistics unit on full train batches.
"""
from __future__ import annotations

import os

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (
    evaluate_single_task, get_base_arguments, joint_loss, launch_ranks,
    log_test_metric, logits_loss, make_loaders, make_mesh, maybe_warm_start,
    needs_launch, reload_state, resolve_device, run_epoch_loop,
    save_checkpoint, single_task_loss)
from artgraph_tpu_torch.data.factories import (get_class_weights,
                                               load_dataset_multimodal)
from artgraph_tpu_torch.models import (ContextNetSingleTask,
                                       MultiModalSingleTask)
from artgraph_tpu_torch.tracking import tracker
from artgraph_tpu_torch.train import EarlyStopping, mse, smooth_l1
from artgraph_tpu_torch.train.trainer import Trainer, adam, sgd_momentum

NETS = {'context-net': ContextNetSingleTask,
        'multi-modal': MultiModalSingleTask}


def net_recipe(net: str, lr: float):
    """(encoder criterion, optimizer, lamb) of a --net (ref :47-54)."""
    if net == 'context-net':
        return smooth_l1, sgd_momentum(lr), 0.9
    return mse, adam(lr), 0.6


def main(argv=None):
    parser = get_base_arguments()
    parser.add_argument('--net', type=str, default='multi-modal',
                        help='The architecture. Options: (context-net|multi-modal)')
    parser.add_argument('--label', type=str, default='genre',
                        help='Label to predict. Options: (style|genre).')
    parser.add_argument('--emb_type', type=str, default='artwork',
                        help='Embedding type. Options: (artwork|style|genre).')
    parser.add_argument('--emb_train', type=str,
                        default='gnn_artwork_genre_embs_graph.pt',
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
        mode='single_task', label=args.label, emb_type=args.emb_type,
        emb_train=args.emb_train)
    loaders = make_loaders({'train': dataset_train, 'valid': dataset_valid,
                            'test': dataset_test}, args.batch,
                            args.num_workers, cache_dir=args.image_cache,
                            resident=args.resident_data,
                            epoch_scan=not args.no_epoch_scan, device=device,
                            mesh=mesh)

    num_class = config.NUM_CLASSES[args.label]
    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model = NETS[args.net](emb_size=config.EMB_SIZE, num_class=num_class)
    class_weights = (get_class_weights(dataset_train, num_class, args.label)
                     if args.with_weights else None)
    class_loss = single_task_loss(class_weights, device)
    encoder_criterion, optimizer, lamb = net_recipe(args.net, args.lr)
    trainer = Trainer(model=model, optimizer=optimizer,
                      compute_loss=joint_loss(class_loss, encoder_criterion,
                                              lamb),
                      eval_compute_loss=logits_loss(class_loss),
                      transform_type='resnet', device=device,
                      seed=config.GLOBAL_SEED, mesh=mesh)
    maybe_warm_start(args, trainer, type(model).__name__)

    checkpoint_name = os.path.join(
        config.CHECKPOINTS_DIR,
        f'{args.label}_{args.net}_single-task_checkpoint.pt')
    early_stop = EarlyStopping(patience=1, min_delta=0.001,
                               checkpoint_path=checkpoint_name,
                               save_fn=save_checkpoint)

    @tracker(args.tracking, 'train')
    def train(epoch):
        m = trainer.train_epoch(loaders['train'])
        print(f'Train loss: {m["loss"]}; train accuracy: {m["correct"]}')
        return m['loss'], m['correct'], epoch

    @tracker(args.tracking, 'valid')
    def valid(epoch):
        m = trainer.eval_epoch(loaders['valid'])
        early_stop(m['loss'], trainer.model)
        print(f'Validation loss: {m["loss"]}; '
              f'validation accuracy: {m["correct"]}')
        return m['loss'], m['correct'], epoch

    run_epoch_loop(args, trainer, (loaders['train'], loaders['valid']),
                   early_stop, train, valid)

    reload_state(trainer, checkpoint_name)
    acc = evaluate_single_task(trainer, loaders['test'], num_class,
                               results_dir=args.results_dir, output_index=0)
    print(f'Test accuracy: {acc}')
    log_test_metric(args, 'test acc', acc)
    return acc


if __name__ == '__main__':
    main()
