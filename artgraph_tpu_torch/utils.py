"""Drop-in re-export of the reference's `utils.py` surface
(ref: src/utils.py) from the port's modules, under the names and with the
`__all__` of artgraph_tpu/utils.py, so code written against the reference
finds every symbol:

    from artgraph_tpu_torch.utils import load_dataset, prepare_dataloader
"""
from artgraph_tpu_torch.cli._common import get_base_arguments
from artgraph_tpu_torch.data.factories import (
    get_class_weights, load_dataset, load_dataset_multimodal,
    load_dataset_multitask_new_multimodal, load_dataset_new_multimodal,
    load_dataset_projection)
from artgraph_tpu_torch.data.loader import prepare_dataloader
from artgraph_tpu_torch.data.manifest import prepare_raw_dataset
from artgraph_tpu_torch.tracking import (track_params, tracker,
                                         tracker_multitask)

__all__ = [
    "get_base_arguments",
    "prepare_raw_dataset",
    "load_dataset",
    "load_dataset_multimodal",
    "load_dataset_new_multimodal",
    "load_dataset_multitask_new_multimodal",
    "load_dataset_projection",
    "get_class_weights",
    "prepare_dataloader",
    "tracker",
    "tracker_multitask",
    "track_params",
]
