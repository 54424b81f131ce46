"""weight_cast_mb.serve: the bytes of the bf16 copies of f32 weight
matrices that a served batch makes, in MB: the port's counter
`weight_cast_bytes` (artgraph_tpu_torch/profiling.py), which adds only
while the profiler records, over the traced batches. Left out when the
port has no such counter."""


def read(view):
    try:
        from artgraph_tpu_torch import profiling
        value = profiling.counters().get("weight_cast_bytes")
    except (ImportError, AttributeError):
        return None
    if value is None or not view.steps:
        return None
    return value / view.steps / 1e6
