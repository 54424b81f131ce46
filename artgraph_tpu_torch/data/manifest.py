"""Raw-manifest assembly: CSV files -> pandas dataframe.

Port of artgraph_tpu/data/manifest.py (ref: src/utils.py:30-49
prepare_raw_dataset): the manifest joins
  mapping/artwork_entidx2name.csv             -> columns [idx, image]
  raw/node-label/artwork/node-label-style.csv -> column  [style]
  raw/node-label/artwork/node-label-genre.csv -> column  [genre]
by row position (positional concat, not a key join).
"""
from __future__ import annotations

import os

import pandas as pd


def prepare_raw_dataset(base_dir: str, type: str) -> pd.DataFrame:
    """The split's manifest, columns [idx, image, style, genre]; `type` is
    the split directory ("train", "validation", "test")."""
    split = os.path.join(base_dir, type)
    artwork = pd.read_csv(
        os.path.join(split, "mapping/artwork_entidx2name.csv"),
        names=["idx", "image"])
    style = pd.read_csv(
        os.path.join(split, "raw/node-label/artwork/node-label-style.csv"),
        names=["style"])
    genre = pd.read_csv(
        os.path.join(split, "raw/node-label/artwork/node-label-genre.csv"),
        names=["genre"])
    return pd.concat([artwork, style, genre], axis=1)
