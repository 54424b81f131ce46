"""The port's models: ViT-B/16 trunk and the four ViT heads."""
from artgraph_tpu_torch.models.heads import (NewMultiModalMultiTaskViT,
                                             NewMultiModalSingleTaskVit,
                                             ViTMultiTask, ViTSingleTask)
from artgraph_tpu_torch.models.vit import ViT, init_random_

__all__ = ["ViT", "ViTSingleTask", "ViTMultiTask",
           "NewMultiModalSingleTaskVit", "NewMultiModalMultiTaskViT",
           "init_random_"]
