"""The port's models: the ViT-B/16, ResNet50 and Swin-B trunks, the classifier,
fusion and context (ContextNet, MultiModal) models and the two projectors;
and the GNNs of `models.gnn`: the KG-embedding stage's HeteroSGNN and the
variants HeteroMGNN, HomoGNN and HomoSGNN."""
from artgraph_tpu_torch.models.heads import (ContextNetlMultiTask,
                                             ContextNetMultiTask,
                                             ContextNetSingleTask,
                                             LabelProjector,
                                             LabelProjectorVit,
                                             MultiModalMultiTask,
                                             MultiModalSingleTask,
                                             NewMultiModalMultiTask,
                                             NewMultiModalMultiTaskSwin,
                                             NewMultiModalMultiTaskViT,
                                             NewMultiModalSingleTask,
                                             NewMultiModalSingleTaskVit,
                                             ResnetMultiTask, ResnetSingleTask,
                                             ViTMultiTask, ViTSingleTask)
from artgraph_tpu_torch.models.resnet import MixedBatchNorm, ResNet50
from artgraph_tpu_torch.models.swin import SwinTransformer
from artgraph_tpu_torch.models.vit import (ViT, init_random_,
                                           vit_base_patch16_224)

_GNN = ("HeteroSGNN", "HeteroMGNN", "HomoGNN", "HomoSGNN")

__all__ = ["ViT", "ResNet50", "MixedBatchNorm", "ViTSingleTask",
           "ViTMultiTask", "NewMultiModalSingleTaskVit",
           "NewMultiModalMultiTaskViT", "NewMultiModalMultiTaskSwin",
           "SwinTransformer",
           "ResnetSingleTask", "ResnetMultiTask",
           "NewMultiModalSingleTask", "NewMultiModalMultiTask",
           "ContextNetSingleTask", "ContextNetlMultiTask",
           "ContextNetMultiTask", "MultiModalSingleTask",
           "MultiModalMultiTask", "LabelProjector", "LabelProjectorVit",
           "vit_base_patch16_224", "init_random_", *_GNN]


def __getattr__(name: str):
    """The GNNs load on first use: models.gnn reads its graphs with pandas,
    which the image paths (`cli.predict`) do not import."""
    if name in _GNN:
        from artgraph_tpu_torch.models import gnn
        return getattr(gnn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
