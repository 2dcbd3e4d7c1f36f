from vitvs_tpu_torch.parallel.mesh import (
    batch_servo_step,
    make_mesh,
    replicate,
    shard_vit_params,
    sharded_batch_rollout,
)

__all__ = [
    "make_mesh",
    "shard_vit_params",
    "replicate",
    "batch_servo_step",
    "sharded_batch_rollout",
]
