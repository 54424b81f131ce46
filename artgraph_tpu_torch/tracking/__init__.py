"""Experiment tracking with the reference's MLflow surface (port of
artgraph_tpu/tracking)."""
from artgraph_tpu_torch.tracking.mlflow_adapter import (log_metric, log_param,
                                                        set_experiment,
                                                        track_params, tracker,
                                                        tracker_multitask)

__all__ = ["tracker", "tracker_multitask", "track_params", "log_metric",
           "log_param", "set_experiment"]
