"""Tuple-space sharding on `torch://` (the reference's spicedb/sharding/,
ROADMAP Queue 1 item 9c).

The tuple space splits BY RESOURCE TYPE across N independent leaders —
each with its own store, WAL and checkpoint lineage and, over
`torch://`, its own graph on the card — behind a `ShardedEndpoint` in
one process, or behind a thin stateless router in front of N
single-shard proxies.  The `relation_footprint` closure proves the
partition safe per schema: a permission whose closure stays on one
shard evaluates identically over that shard's tuple subset, and a
closure spanning two shards is a hard startup error (SL007).  Client
ZedTokens become revision VECTORS (`{shard: revision}`); each shard
leader enforces only its own component through the existing
`X-Authz-Min-Revision` gate.

- `partition.py`  PartitionMap: `type=shard` assignments + default
                  shard, footprint validation, write-batch routing.
- `revvec.py`     revision-vector ZedToken encode/decode/merge.
- `router.py`     ShardedEndpoint, MergedWatcher, build_sharded_endpoint
                  and ShardRouter/RouterServer.
- `metrics.py`    the switch-gated `authz_shard_*` series.

Killswitch: the SHARDING switch (utils/features.py) — off, nothing here
is constructed and the proxy is exactly single-shard.
"""

from .metrics import enabled
from .partition import (
    CrossShardWriteError,
    INTERNAL_TYPES,
    PartitionMap,
    PartitionMapError,
    partition_map_for_schema,
)
from .revvec import RevisionVector, RevisionVectorError
from .router import (
    MergedWatcher,
    RouterConfigError,
    RouterServer,
    ShardRouter,
    ShardedEndpoint,
    build_routing_table,
    build_sharded_endpoint,
)

__all__ = [
    "CrossShardWriteError",
    "INTERNAL_TYPES",
    "MergedWatcher",
    "PartitionMap",
    "PartitionMapError",
    "RevisionVector",
    "RevisionVectorError",
    "RouterConfigError",
    "RouterServer",
    "ShardRouter",
    "ShardedEndpoint",
    "build_routing_table",
    "build_sharded_endpoint",
    "enabled",
    "partition_map_for_schema",
]
