from artgraph_tpu_torch.parallel.mesh import (
    ColumnParallelLinear,
    DataMesh,
    batch_sharding,
    create_mesh,
    current_mesh,
    distributed_init,
    gather_params,
    global_batch_array,
    replicated,
    shard_params,
    spawn,
)

__all__ = [
    "ColumnParallelLinear",
    "DataMesh",
    "batch_sharding",
    "create_mesh",
    "current_mesh",
    "distributed_init",
    "gather_params",
    "global_batch_array",
    "replicated",
    "shard_params",
    "spawn",
]
