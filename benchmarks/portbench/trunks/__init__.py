"""The benchmark's model layer: one module per value of a configuration's
"trunk" key, found by that name (`get`). A configuration on a new trunk
plugs in with `portbench/trunks/<trunk>.py`, its configuration and
workload files and their BENCHMARK.json entries; no other file changes.

A trunk module supplies:
  PREFIX              the attribute holding the trunk in the port's fusion
                      model and in the plain one (their state_dict names
                      match);
  fusion_class()      the port's fusion class, built with (emb_size,
                      num_classes, dropout, dtype); it imports the port when
                      called, so the plain reference loads none of it;
  Plain               the plain f32 trunk: Plain(cfg)(NHWC normalized
                      images, reference.Precision) -> [B, feature_dim(cfg)];
  feature_dim(cfg), forward_flops(cfg)
                      the feature's width; model FLOPs of one image's
                      forward through the trunk;
  init_scale(name, shape, cfg)
                      optional: (offset, std) of a leaf's seeded draw, or
                      None for inputs._scale's generic rules;
  TINY, patch_tiny(monkeypatch)
                      the CPU rehearsal's test-only sizes, merged into the
                      configuration, and the patch that makes the port
                      build the trunk at them.
"""
from __future__ import annotations

import importlib
from types import ModuleType


def get(cfg: dict) -> ModuleType:
    """The module of the configuration's trunk."""
    name = cfg["trunk"]
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ModuleNotFoundError(
            f"no trunk {name!r}: add benchmarks/portbench/trunks/{name}.py "
            f"(see {__name__}'s docstring)", name=module) from None
