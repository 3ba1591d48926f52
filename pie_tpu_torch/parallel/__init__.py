"""Multi-process execution: the ("dp", "tp") mesh, the tensor-parallel
shard plan and the collectives of the sharded forwards, multi-host
bring-up and liveness, and the front tier's request router. Port of the
JAX package's ``pie_tpu/parallel/`` over ``torch.distributed``."""

from pie_tpu_torch.parallel.mesh import make_mesh
from pie_tpu_torch.parallel.tp import (
    local_config,
    mesh_ops,
    param_plan,
    replicate_kv_heads,
    shard_cache,
    shard_model,
    shard_params,
    shard_pool,
)
