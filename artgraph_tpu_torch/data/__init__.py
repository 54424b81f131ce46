"""Host-side data: manifests, image decode, datasets, the static-shape loader.

Port of the single-task image part of artgraph_tpu/data. The submodules are
imported by name (`data.transforms`, `data.loader`, ...): this package
imports none of them itself, so `cli.predict`, which needs only the decoder,
does not load pandas.
"""
