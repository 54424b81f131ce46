from artgraph_tpu_torch.parallel.mesh import (
    DataMesh,
    batch_sharding,
    create_mesh,
    current_mesh,
    distributed_init,
    global_batch_array,
    replicated,
    shard_params,
    spawn,
)

__all__ = [
    "DataMesh",
    "batch_sharding",
    "create_mesh",
    "current_mesh",
    "distributed_init",
    "global_batch_array",
    "replicated",
    "shard_params",
    "spawn",
]
