"""Multi-device training and serving: the ('data', 'model') mesh, its
collectives, and each rank's share of a batch (the counterpart of the JAX
package's parallel/)."""

from videonavqa_tpu_torch.parallel.mesh import (  # noqa: F401
    DEFAULT_MODEL_SHARDED, Mesh, MeshRank, batch_sharding, make_mesh, param_shardings,
    put_global, replicate, shard_batch,
)
