from repro_torch.parallel.executor import ShardedExecutor  # noqa: F401
from repro_torch.parallel.sharding import (  # noqa: F401
    P,
    NamedSharding,
    named_sharding_tree,
    zero1_specs,
    spec_bytes_per_device,
)
