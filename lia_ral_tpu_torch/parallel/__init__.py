"""Device-mesh parallelism: sharded stat accumulation, multi-process
helpers (port of lia_ral_tpu/parallel).

The reference's two scale mechanisms: the pthread worker pools
(per-thread accumulators merged with addAccEM) become shards of a mesh
whose partial stats are summed in shard order (``Mesh.run``, one thread
and one CUDA stream a shard), and the file-level batch parallelism
becomes multi-process data parallelism over the same mesh
(``parallel.distributed``, gloo).
"""

from .mesh import device_count, make_mesh
from .sharding import (
    shard_frames,
    sharded_em_stats,
    sharded_em_stats_2d,
    sharded_stats_fn,
)

__all__ = [
    "make_mesh", "device_count",
    "shard_frames", "sharded_em_stats", "sharded_em_stats_2d",
    "sharded_stats_fn",
]
