"""Test-split metrics and the reference-schema results CSVs."""
from artgraph_tpu_torch.metrics.classification import summarize
from artgraph_tpu_torch.metrics.results import write_results

__all__ = ["summarize", "write_results"]
