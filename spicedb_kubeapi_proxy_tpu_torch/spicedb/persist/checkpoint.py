"""Columnar checkpoint files + the recovery manifest.

A checkpoint serializes the tuple store's full live state at one revision
into a single `.npz`: the six interned int32 columns + expiry column +
string pool of `ColumnarSnapshot` (vectorized — no per-tuple objects on
the 1M path) plus a JSON `meta` blob carrying the revision, the WAL
segment watermark, and the overlay: caveated tuples (which never enter
the columnar plane, store.py `bulk_load_text`) as full relationship
strings with their `[caveat:...]` / `[expiration:...]` suffixes.

Files are written atomically (tmp + fsync + rename + dir fsync), so a
crash mid-checkpoint leaves the previous checkpoint/manifest intact; the
`checkpointBeforeRename` / `manifestBeforeRename` failpoints sit exactly
on those windows for the crash tests.

The same format backs the WAL's bulk-load snapshot sidecars (manager.py):
one serializer, one loader, one set of invariants.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from ..columnar import _COLS, ColumnarSnapshot
from ..types import parse_relationship
from ...utils.failpoints import fail_point
from .wal import _fsync_dir

MANIFEST_NAME = "MANIFEST.json"
CHECKPOINT_DIR = "checkpoints"


def checkpoint_name(revision: int) -> str:
    return f"ckpt-{revision:012d}.npz"


def _atomic_write(path: str, write_fn: Callable, failpoint: str = "") -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    if failpoint:
        fail_point(failpoint)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def save_columnar_file(path: str, pool: list, cols: dict,
                       expiry: np.ndarray, overlay: list, meta: dict,
                       failpoint: str = "") -> None:
    """Serialize one store state: `cols` maps the six column names to
    int32 arrays, `overlay` is relationship strings (caveated/object-path
    tuples), `meta` at least {"revision": int}."""
    meta = dict(meta, overlay=list(overlay))

    def write(f):
        np.savez(
            f,
            expiry=np.ascontiguousarray(expiry, dtype=np.float64),
            pool_json=np.frombuffer(
                json.dumps(pool).encode(), dtype=np.uint8),
            meta_json=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8),
            **{name: np.ascontiguousarray(cols[name], dtype=np.int32)
               for name in _COLS})

    _atomic_write(path, write, failpoint=failpoint)


def load_columnar_file(path: str) -> tuple:
    """-> (ColumnarSnapshot, overlay Relationship list, meta dict)."""
    with np.load(path) as d:
        pool = json.loads(d["pool_json"].tobytes().decode())
        meta = json.loads(d["meta_json"].tobytes().decode())
        arrays = [np.array(d[name], dtype=np.int32) for name in _COLS]
        expiry = np.array(d["expiry"], dtype=np.float64)
    snap = ColumnarSnapshot(pool, *arrays, expiry=expiry)
    overlay = [parse_relationship(s) for s in meta.get("overlay", ())]
    return snap, overlay, meta


def write_manifest(data_dir: str, manifest: dict,
                   failpoint: str = "") -> None:
    path = os.path.join(data_dir, MANIFEST_NAME)
    body = json.dumps(manifest, sort_keys=True).encode()
    _atomic_write(path, lambda f: f.write(body), failpoint=failpoint)


def read_manifest(data_dir: str) -> Optional[dict]:
    path = os.path.join(data_dir, MANIFEST_NAME)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    # the manifest is written atomically, so undecodable JSON means
    # external damage — let it surface (ValueError) rather than silently
    # rebooting into an empty store
    data = json.loads(raw)
    if not isinstance(data, dict) or "revision" not in data:
        return None
    return data


def default_manifest(revision: int, checkpoint_file: str,
                     watermark: int) -> dict:
    return {"revision": int(revision), "checkpoint": checkpoint_file,
            "watermark": int(watermark), "created_unix": time.time()}
