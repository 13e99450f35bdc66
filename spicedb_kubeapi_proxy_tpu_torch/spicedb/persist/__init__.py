"""Durable relationship store: segmented WAL, columnar checkpoints, and
crash recovery for the in-memory TupleStore (reference spicedb/persist;
the on-disk format is the reference's, so a data dir moves between the
`jax://` and `torch://` deployments both ways).

- wal.py        CRC-framed segmented append-only log
- checkpoint.py columnar checkpoint files + the atomic recovery manifest
- manager.py    PersistenceManager: recover / attach / checkpoint loop
"""

from .checkpoint import read_manifest
from .manager import (
    DEFAULT_CHECKPOINT_INTERVAL,
    PersistenceManager,
    PersistenceUnavailableError,
)
from .wal import (
    DEFAULT_SEGMENT_BYTES,
    FSYNC_ALWAYS,
    FSYNC_INTERVAL,
    FSYNC_NEVER,
    FSYNC_POLICIES,
    SegmentedWal,
    WalCorruptionError,
)

__all__ = [
    "DEFAULT_CHECKPOINT_INTERVAL",
    "DEFAULT_SEGMENT_BYTES",
    "FSYNC_ALWAYS",
    "FSYNC_INTERVAL",
    "FSYNC_NEVER",
    "FSYNC_POLICIES",
    "PersistenceManager",
    "PersistenceUnavailableError",
    "SegmentedWal",
    "WalCorruptionError",
    "read_manifest",
]
