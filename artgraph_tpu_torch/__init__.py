"""artgraph_tpu_torch — PyTorch/CUDA port of artgraph_tpu for NVIDIA Hopper.

The JAX package `artgraph_tpu` stays the reference; this package sits beside
it and is held against it by the tests/test_torch_*.py suite. It imports
torch and never jax. Its first slice is the serving path (`cli.predict`) on
the ViT-B/16 models:

  ops/            hand-written CUDA kernels (csrc/, built with nvcc at first
                  use) for the fused block attention, the fused block MLP and
                  the uint8 normalize, each beside its plain PyTorch version
  models/         ViT-B/16 trunk and the four ViT classifier / fusion heads,
                  with the reference (timm) state_dict keys
  checkpointing/  reference .pt loading and the JAX-variables carry-over
  cli/            predict
"""

__version__ = "0.1.0"
