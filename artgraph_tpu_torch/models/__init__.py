"""The port's models: the ViT-B/16 and ResNet50 trunks, the classifier,
fusion and context (ContextNet, MultiModal) models and the two projectors;
the hetero-GNN of the KG-embedding stage is `models.gnn`, imported by
name."""
from artgraph_tpu_torch.models.heads import (ContextNetlMultiTask,
                                             ContextNetMultiTask,
                                             ContextNetSingleTask,
                                             LabelProjector,
                                             LabelProjectorVit,
                                             MultiModalMultiTask,
                                             MultiModalSingleTask,
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
           "ContextNetSingleTask", "ContextNetlMultiTask",
           "ContextNetMultiTask", "MultiModalSingleTask",
           "MultiModalMultiTask", "LabelProjector", "LabelProjectorVit",
           "init_random_"]
