"""Counting over device meshes and across processes (port of
bear_tpu/parallel)."""

# The counting package first: its multipass and sparse counters subclass
# KmerShardedTransitionCounter, so importing this package first must not
# reach them while parallel.counting is half defined.
import bear_tpu_torch.counting  # noqa: F401
from bear_tpu_torch.parallel import multihost
from bear_tpu_torch.parallel.counting import (
    KmerShardedTransitionCounter,
    ShardedTransitionCounter,
)
from bear_tpu_torch.parallel.mesh import (
    Mesh,
    data_parallel_mesh,
    grid_mesh,
    local_device_count,
    put_global,
    replicate,
    shard_along,
)

__all__ = ["KmerShardedTransitionCounter", "Mesh", "ShardedTransitionCounter",
           "data_parallel_mesh", "grid_mesh", "local_device_count", "multihost",
           "put_global", "replicate", "shard_along"]
