"""WAL-shipping read replication (reference spicedb/replication).

The durable store's segmented CRC-framed WAL + columnar checkpoints
(spicedb/persist) are already a replication log: WAL-before-visibility
ordering guarantees any shipped record is replayable, and the revision
counter is the ZedToken.  This package ships that log over HTTP:

- **Leader** (`leader.py` ReplicationHub): serves the live data dir —
  `/replication/manifest` (revision + artifact listing, with a long-poll
  "wait for revision > R" mode fed by the store's commit-listener hook),
  `/replication/segment/<name>` and `/replication/checkpoint/<name>`
  (raw bytes with offset/range semantics, safe-name validated).

- **Follower** (`follower.py` ReplicaFollower): bootstraps from the
  newest checkpoint, tails segments, applies records through the
  exact-replay `TupleStore.apply_replica_batch` path into the live
  store — driving the normal delta pipeline (the `torch://` device
  graph's deltas and `scatter_rows` flushes, decision-cache epoch
  bumps, watch events) — and re-bootstraps from the checkpoint instead
  of diverging when the tail is torn or reclaimed; a re-bootstrap resets
  the store, and the device graph rebuilds at the next read.

Consistency contract: a follower serves any read whose min-revision
(ZedToken, `X-Authz-Min-Revision`) it has already applied; fresher
reads wait up to `replica_wait_ms` and then forward to the leader (or
503 naming it).  Update verbs always go to the leader.  The
`REPLICATION` switch (utils/features.py, the reference's `Replication`
gate) is the killswitch: off, routes and follower mode are inert and the
proxy is exactly single-node.  Failover (promotion, fan-out trees,
fencing probes) is not part of this package.
"""

from .follower import ReplicaFollower, StaleLeaderError
from .leader import (
    INCARNATION_HEADER,
    LEADER_ID_HEADER,
    ReplicationHub,
    safe_artifact_name,
)

MIN_REVISION_HEADER = "X-Authz-Min-Revision"
REVISION_HEADER = "X-Authz-Revision"


def enabled() -> bool:
    """The REPLICATION switch, read at each use."""
    from ...utils import features
    return features.REPLICATION


__all__ = [
    "INCARNATION_HEADER",
    "LEADER_ID_HEADER",
    "MIN_REVISION_HEADER",
    "REVISION_HEADER",
    "ReplicaFollower",
    "ReplicationHub",
    "StaleLeaderError",
    "enabled",
    "safe_artifact_name",
]
