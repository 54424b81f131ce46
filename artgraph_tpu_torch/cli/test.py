"""Tracking smoke script (ref: src/test.py, the reference's only
'test'-named file): the tracking decorator over fake losses — port of
artgraph_tpu/cli/test.py.

    python -m artgraph_tpu_torch.cli.test -t --exp smoke

With -t the arguments and five epochs' `train loss` and `train acc` go to
MLflow, or, without the mlflow package, to the file store under ./mlruns.
"""
from __future__ import annotations

import argparse
import random

from artgraph_tpu_torch.tracking import track_params, tracker


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--exp', type=str, default='test',
                        help='Experiment name.')
    parser.add_argument('-t', '--tracking', action='store_true')
    args = parser.parse_args(argv)

    if args.tracking:
        track_params(args)

    @tracker(args.tracking, 'train')
    def fake_epoch(epoch):
        return random.random(), random.random(), epoch

    for epoch in range(5):
        loss, acc, _ = fake_epoch(epoch)
        print(f'epoch {epoch}: loss={loss:.4f} acc={acc:.4f}')


if __name__ == '__main__':
    main()
