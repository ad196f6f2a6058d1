from seamless_communication_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    param_partition_spec,
    shard_params,
    with_param_shardings,
)
