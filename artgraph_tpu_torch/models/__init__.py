"""The port's models: ViT-B/16 trunk and the four ViT heads; the
hetero-GNN of the KG-embedding stage is `models.gnn`, imported by name."""
from artgraph_tpu_torch.models.heads import (NewMultiModalMultiTaskViT,
                                             NewMultiModalSingleTaskVit,
                                             ViTMultiTask, ViTSingleTask)
from artgraph_tpu_torch.models.vit import ViT, init_random_

__all__ = ["ViT", "ViTSingleTask", "ViTMultiTask",
           "NewMultiModalSingleTaskVit", "NewMultiModalMultiTaskViT",
           "init_random_"]
