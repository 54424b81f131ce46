"""Reference .pt checkpoints and the JAX package's weights, carried over."""
from artgraph_tpu_torch.checkpointing.torch_interop import (
    attention_state_from_flax, gnn_state_from_flax, load_reference_checkpoint,
    resnet_state_from_flax, save_reference_checkpoint, state_dict_from_flax,
    vit_state_from_flax)

__all__ = ["attention_state_from_flax", "gnn_state_from_flax",
           "load_reference_checkpoint", "resnet_state_from_flax",
           "save_reference_checkpoint", "state_dict_from_flax",
           "vit_state_from_flax"]
