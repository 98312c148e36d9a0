from dss_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_train_step,
    replicate,
    shard_views,
)
