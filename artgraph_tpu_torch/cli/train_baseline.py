"""Image-only single-task baseline trainer on the GPU — port of
artgraph_tpu/cli/train_baseline.py.

Same flags as the reference's src/train_baseline.py (--label,
--architecture, --dropout + the base arguments), checkpoint name, patience
(10), loss (cross-entropy, optional class weights), Adam, prints and MLflow
metrics, plus `--device` (default `cuda`) and the JAX CLI's
--init_checkpoint and --resume:

    python -m artgraph_tpu_torch.cli.train_baseline --architecture resnet \
        --dataset_path <dataset> --image_path <images> --label style

`--architecture resnet` (the default) trains ResnetSingleTask, anything else
ViTSingleTask, as the JAX CLI does. On `cuda` every step runs the normalize
kernel; the ViT runs, in each of the 12 blocks, the block attention and
block MLP kernels forward and backward; ResNet50 runs cuDNN convolutions
and, with ARTGRAPH_CONVBN=1 in the environment, the fused 1x1-conv +
BN-statistics unit in each bottleneck forward and backward (off by default,
as in the JAX package). The ragged last batch's BN statistics cover its
valid rows only.
"""
from __future__ import annotations

import os

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (
    evaluate_single_task, get_base_arguments, launch_ranks, log_test_metric,
    make_loaders, make_mesh, maybe_warm_start, needs_launch, reload_state,
    resolve_device, run_epoch_loop, save_checkpoint, single_task_loss)
from artgraph_tpu_torch.data.factories import get_class_weights, load_dataset
from artgraph_tpu_torch.models import ResnetSingleTask, ViTSingleTask
from artgraph_tpu_torch.tracking import tracker
from artgraph_tpu_torch.train import EarlyStopping
from artgraph_tpu_torch.train.trainer import Trainer, adam


def main(argv=None):
    parser = get_base_arguments()
    parser.add_argument('--label', type=str, default='genre',
                        help='Label to predict (style|genre).')
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
        mode='single_task', label=args.label, transform_type=args.architecture)
    loaders = make_loaders({'train': dataset_train, 'valid': dataset_valid,
                            'test': dataset_test}, args.batch,
                            args.num_workers, cache_dir=args.image_cache,
                            resident=args.resident_data,
                            epoch_scan=not args.no_epoch_scan, device=device,
                            mesh=mesh)

    num_class = config.NUM_CLASSES[args.label]
    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model_cls = (ResnetSingleTask if args.architecture == 'resnet'
                 else ViTSingleTask)
    model = model_cls(num_class, args.dropout)
    class_weights = (get_class_weights(dataset_train, num_class, args.label)
                     if args.with_weights else None)
    trainer = Trainer(model=model, optimizer=adam(args.lr),
                      compute_loss=single_task_loss(class_weights, device),
                      transform_type=args.architecture, device=device,
                      seed=config.GLOBAL_SEED, mesh=mesh)
    maybe_warm_start(args, trainer, model_cls.__name__)

    checkpoint_name = os.path.join(
        config.CHECKPOINTS_DIR,
        f'{args.label}_{args.architecture}_baseline_single-task_checkpoint.pt')
    early_stop = EarlyStopping(patience=10, min_delta=0.001,
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

    # test(): the model from the best checkpoint
    # (ref: train_baseline.py:102-128)
    reload_state(trainer, checkpoint_name)
    acc = evaluate_single_task(trainer, loaders['test'], num_class,
                               results_dir=args.results_dir)
    print(f'Test accuracy: {acc}')
    log_test_metric(args, 'test acc', acc)
    return acc


if __name__ == '__main__':
    main()
