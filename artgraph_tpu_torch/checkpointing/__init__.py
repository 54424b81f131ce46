"""Reference .pt checkpoints, the JAX package's weights carried over, and
the full train states of --resume."""
from artgraph_tpu_torch.checkpointing.state_io import (restore_checkpoint,
                                                       save_checkpoint)
from artgraph_tpu_torch.checkpointing.torch_interop import (
    attention_state_from_flax, gnn_state_from_flax, import_trunk_state,
    load_reference_checkpoint, resnet_state_from_flax,
    save_reference_checkpoint, state_dict_from_flax, vit_state_from_flax)

__all__ = ["attention_state_from_flax", "gnn_state_from_flax",
           "import_trunk_state", "load_reference_checkpoint",
           "resnet_state_from_flax", "restore_checkpoint", "save_checkpoint",
           "save_reference_checkpoint", "state_dict_from_flax",
           "vit_state_from_flax"]
