from scasml_gp_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
    train_point_sharding,
)
from scasml_gp_torch.parallel.sharded import (
    dryrun_multichip,
    make_sharded_picard_solve,
    make_sharded_train_and_solve,
)

__all__ = [
    "batch_sharding",
    "initialize_distributed",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
    "shard_batch",
    "train_point_sharding",
    "dryrun_multichip",
    "make_sharded_picard_solve",
    "make_sharded_train_and_solve",
]
