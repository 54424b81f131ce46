"""The port's models: the ViT-B/16 and ResNet50 trunks, the eight
classifier and fusion models of `predict` and the two projectors; the
hetero-GNN of the KG-embedding stage is `models.gnn`, imported by name."""
from artgraph_tpu_torch.models.heads import (LabelProjector,
                                             LabelProjectorVit,
                                             NewMultiModalMultiTask,
                                             NewMultiModalMultiTaskViT,
                                             NewMultiModalSingleTask,
                                             NewMultiModalSingleTaskVit,
                                             ResnetMultiTask, ResnetSingleTask,
                                             ViTMultiTask, ViTSingleTask)
from artgraph_tpu_torch.models.resnet import MixedBatchNorm, ResNet50
from artgraph_tpu_torch.models.vit import ViT, init_random_

__all__ = ["ViT", "ResNet50", "MixedBatchNorm", "ViTSingleTask",
           "ViTMultiTask", "NewMultiModalSingleTaskVit",
           "NewMultiModalMultiTaskViT", "ResnetSingleTask", "ResnetMultiTask",
           "NewMultiModalSingleTask", "NewMultiModalMultiTask",
           "LabelProjector", "LabelProjectorVit", "init_random_"]
