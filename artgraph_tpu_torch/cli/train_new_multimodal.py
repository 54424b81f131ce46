"""New-multimodal single-task trainer on the GPU (the proposed model, one
head, ResNet50) — port of artgraph_tpu/cli/train_new_multimodal.py.

Same flags as the reference's src/train_new_multimodal.py (--label,
--emb_desc, --emb_type, --emb_train, --emb_valid, --emb_test, --dropout +
the base arguments), plus `--device` (default `cuda`): NewMultiModalSingleTask
trained with the TRUE KG embeddings and validated and tested with the
PROJECTED ones (ref: utils.py:120-153), cross-entropy, Adam, patience 3,
images normalized with the ResNet statistics:

    python -m artgraph_tpu_torch.cli.train_new_multimodal --label genre \
        --dataset_path <dataset> --image_path <images> --emb_type artwork \
        --emb_train <f> --emb_valid <f> --emb_test <f>

Early stopping watches the NEGATIVE validation accuracy
(early_stop(-epoch_acc), ref :99), kept as the reference has it.
"""
from __future__ import annotations

import os

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (
    evaluate_single_task, get_base_arguments, launch_ranks, log_test_metric,
    make_loaders, make_mesh, maybe_warm_start, needs_launch, reload_state,
    resolve_device, run_epoch_loop, save_checkpoint, single_task_loss)
from artgraph_tpu_torch.data.factories import (get_class_weights,
                                               load_dataset_new_multimodal)
from artgraph_tpu_torch.models import NewMultiModalSingleTask
from artgraph_tpu_torch.tracking import tracker
from artgraph_tpu_torch.train import EarlyStopping
from artgraph_tpu_torch.train.trainer import Trainer, adam


def image_and_embedding(img, batch):
    """forward_inputs; batch (img, embedding, label, mask)."""
    return img, batch[1]


def main(argv=None):
    parser = get_base_arguments()
    parser.add_argument('--label', type=str, default='genre',
                        help='Label to predict. Options: (style|genre).')
    parser.add_argument('--emb_desc', type=str, default='genre',
                        help='(gnn|metapath2vec).')
    parser.add_argument('--emb_type', type=str, default='genre',
                        help='Embedding type (artwork|genre|style).')
    parser.add_argument('--emb_train', type=str,
                        default='gnn_genre_embs_graph.pt',
                        help='Embedding train file name.')
    parser.add_argument('--emb_valid', type=str,
                        default='gnn_genre_valid_embs_graph.pt',
                        help='Embedding train file name.')
    parser.add_argument('--emb_test', type=str,
                        default='gnn_genre_test_embs_graph.pt',
                        help='Embedding train file name.')
    parser.add_argument('--dropout', type=float, default=0.4, help='Dropout')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if needs_launch(args):
        return launch_ranks(args, main, argv)
    mesh = make_mesh(args)

    dataset_train, dataset_valid, dataset_test = load_dataset_new_multimodal(
        base_dir=args.dataset_path, image_dir=args.image_path,
        label=args.label, emb_type=args.emb_type, emb_train=args.emb_train,
        emb_valid=args.emb_valid, emb_test=args.emb_test)
    loaders = make_loaders({'train': dataset_train, 'valid': dataset_valid,
                            'test': dataset_test}, args.batch,
                            args.num_workers, cache_dir=args.image_cache,
                            resident=args.resident_data,
                            epoch_scan=not args.no_epoch_scan, device=device,
                            mesh=mesh)

    num_class = config.NUM_CLASSES[args.label]
    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model = NewMultiModalSingleTask(emb_size=config.EMB_SIZE,
                                    num_class=num_class, dropout=args.dropout)
    class_weights = (get_class_weights(dataset_train, num_class, args.label)
                     if args.with_weights else None)
    trainer = Trainer(model=model, optimizer=adam(args.lr),
                      compute_loss=single_task_loss(class_weights, device),
                      transform_type='resnet', device=device,
                      seed=config.GLOBAL_SEED, mesh=mesh,
                      forward_inputs=image_and_embedding)
    maybe_warm_start(args, trainer, type(model).__name__)

    checkpoint_name = os.path.join(
        config.CHECKPOINTS_DIR,
        f'{args.label}_new-multimodal_single-task_checkpoint.pt')
    early_stop = EarlyStopping(patience=3, min_delta=0.001,
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
        # the reference early-stops on the NEGATIVE accuracy here (ref :99)
        early_stop(-m['correct'], trainer.model)
        print(f'Validation loss: {m["loss"]}; '
              f'validation accuracy: {m["correct"]}')
        return m['loss'], m['correct'], epoch

    run_epoch_loop(args, trainer, (loaders['train'], loaders['valid']),
                   early_stop, train, valid)

    reload_state(trainer, checkpoint_name)
    acc = evaluate_single_task(trainer, loaders['test'], num_class,
                               results_dir=args.results_dir)
    print(f'Test accuracy: {acc}')
    log_test_metric(args, 'test acc', acc)
    return acc


if __name__ == '__main__':
    main()
