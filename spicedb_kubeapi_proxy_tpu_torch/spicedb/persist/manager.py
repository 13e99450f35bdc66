"""Durable relationship store: WAL + checkpoints + crash recovery.

`PersistenceManager` owns one data directory:

    <data-dir>/
      MANIFEST.json            newest durable checkpoint (atomic rename)
      checkpoints/ckpt-*.npz   columnar checkpoints (checkpoint.py)
      wal/seg-*.wal            CRC-framed record segments (wal.py)
      wal/snap-*.npz           bulk-load snapshot sidecars

Lifecycle:

    mgr = PersistenceManager(data_dir, ...)
    store = mgr.recover()       # checkpoint load + WAL tail replay
    mgr.attach(store)           # journal every commit from here on
    ... create_endpoint(..., store=store); serve ...
    await mgr.start()           # periodic checkpoint loop
    await mgr.stop()            # final checkpoint + close

Journaling rides the store's commit listeners, which fire synchronously
under the store lock: the WAL observes exactly the committed revision
order, and no reader can see a revision the WAL hasn't.  Record
vocabulary (compact JSON, see wal.py for framing):

    {"k":"d","r":REV,"u":[["t"|"d", rel_string],...],"i":[idem_ids]}
    {"k":"s","r":REV,"f":"snap-REV.npz"}     columnar bulk load (sidecar
                                             written+fsynced BEFORE the
                                             record referencing it)
    {"k":"b","r":REV,"u":[rel_string,...]}   object-path bulk load
    {"k":"c","r":REV}                        delete_all

`"i"` carries the dual-write idempotency-key activity ids present in the
batch (workflow:*#idempotency_key@activity:*): after a crash the
recovered store still holds those tuples, which is what lets a replayed
`write_to_spicedb` activity detect an already-applied write
(authz/distributedtx/activity.py) instead of double-writing.

Recovery restores the revision counter (`TupleStore.adopt_recovery_state`
sets the checkpoint's exact revision; `apply_recovery_batch` advances it
once per replayed record, cross-checked against each record's stamp),
so ZedTokens (checked_at), decision-cache epochs, and watch revisions
stay continuous across a restart — a revision is never reused for
different state.  Expirations ride along (the expiry column + rel-string
suffixes), so `TupleStore.expiry_schedule()` reseeds the decision-cache
and device-graph expiry heaps with pre-crash deadlines.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
import weakref
from typing import Optional

import numpy as np

from ...utils import metrics as m
from ...utils import tracing
from ...utils.failpoints import FailPointPanic
from ..columnar import _COLS, ColumnarSnapshot
from ..store import TupleStore
from ..types import RelationshipUpdate, UpdateOp, parse_relationship
from . import checkpoint as ckpt
from .wal import (
    DEFAULT_SEGMENT_BYTES,
    FSYNC_INTERVAL,
    SegmentedWal,
    WalCorruptionError,
)

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.persist")

DEFAULT_CHECKPOINT_INTERVAL = 300.0

# dual-write idempotency-key tuple shape (activity.py): recovery
# coordination metadata carried in delta records
_IDEM_TYPE = "workflow"
_IDEM_RELATION = "idempotency_key"


class PersistenceUnavailableError(RuntimeError):
    """A WAL append failed earlier in this process.  The aborted commit
    never became visible (the store journals BEFORE mutating), but the
    failed append may still have landed a complete frame on disk — the
    revision number it named cannot safely be reused for different
    state, so the store fails stop: writes keep erroring until a
    restart re-derives the truth from the log."""


# switch off = no manager exists (the server requires a data dir AND the
# DURABLE_STORE switch before constructing one): nothing journals or counts
class PersistenceManager:
    """Segmented WAL + periodic columnar checkpoints over one data dir."""

    def __init__(self, data_dir: str,
                 fsync: str = FSYNC_INTERVAL,
                 fsync_interval: float = 1.0,
                 checkpoint_interval: float = DEFAULT_CHECKPOINT_INTERVAL,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 clock=time.time,
                 registry: Optional[m.Registry] = None):
        if checkpoint_interval <= 0:
            raise ValueError("checkpoint_interval must be > 0")
        self.data_dir = data_dir
        self.checkpoint_interval = checkpoint_interval
        self._clock = clock
        self.ckpt_dir = os.path.join(data_dir, ckpt.CHECKPOINT_DIR)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.wal = SegmentedWal(os.path.join(data_dir, "wal"),
                                fsync=fsync, fsync_interval=fsync_interval,
                                segment_bytes=segment_bytes,
                                registry=registry)
        self._store: Optional[TupleStore] = None
        self._task: Optional[asyncio.Task] = None
        self._flush_task: Optional[asyncio.Task] = None
        self._wal_failed = False
        # checkpoint cycles must not overlap: stop()'s final checkpoint
        # can race an in-flight periodic one (task.cancel does not stop
        # the executor thread), and two concurrent _reclaim passes could
        # delete each other's just-published checkpoint file
        self._ckpt_lock = threading.Lock()
        self.recovered = False
        self.recovery_info: dict = {}
        self._last_ckpt_revision = 0
        self._last_ckpt_unix: Optional[float] = None
        registry = registry or m.REGISTRY
        self._ckpt_hist = registry.histogram(
            "authz_checkpoint_seconds",
            "Wall time of one store checkpoint (capture + serialize + "
            "manifest + reclaim)",
            buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
        self._ckpt_total = registry.counter(
            "authz_checkpoints_total", "Completed store checkpoints")
        ref = weakref.ref(self)

        def _age() -> float:
            mgr = ref()
            if mgr is None or mgr._last_ckpt_unix is None:
                return -1.0
            return time.time() - mgr._last_ckpt_unix

        registry.gauge(
            "authz_checkpoint_age_seconds",
            "Seconds since the newest durable checkpoint (-1 = none yet)",
            callback=_age)
        def _segments() -> float:
            mgr = ref()
            return float(mgr.wal.segment_count()) if mgr is not None else 0.0

        def _wal_bytes() -> float:
            mgr = ref()
            return float(mgr.wal.total_bytes()) if mgr is not None else 0.0

        registry.gauge(
            "authz_wal_segments",
            "Live write-ahead-log segment files", callback=_segments)
        registry.gauge(
            "authz_wal_bytes",
            "Total bytes across live write-ahead-log segments",
            callback=_wal_bytes)

    # -- recovery ------------------------------------------------------------

    def recover(self) -> TupleStore:
        """Build a TupleStore from the newest valid checkpoint plus the
        WAL tail; restores the revision counter.  Safe on an empty data
        dir (returns a fresh store at revision 0, `recovered` False —
        the bootstrap-once signal)."""
        store = TupleStore(clock=self._clock)
        info = {"checkpoint_revision": 0, "replayed_records": 0,
                "replayed_updates": 0, "idempotency_keys": 0,
                "torn_records": 0}
        t0 = time.perf_counter()
        with tracing.request_trace(op="store_recovery") as tr:
            with tracing.span("recovery.checkpoint_load", phase=True):
                manifest = ckpt.read_manifest(self.data_dir)
                if manifest is not None:
                    self._load_checkpoint(store, manifest, info)
            with tracing.span("recovery.wal_replay", phase=True):
                self._replay_wal(store, info)
            info["torn_records"] = self.wal.torn_records
            info["revision"] = store.revision
            tr.attrs.update(revision=store.revision)
        tracing.RECORDER.record(tr)
        phases = tr.phase_durations()
        info["checkpoint_load_s"] = round(
            phases.get("recovery.checkpoint_load", 0.0), 6)
        info["wal_replay_s"] = round(
            phases.get("recovery.wal_replay", 0.0), 6)
        info["total_s"] = round(time.perf_counter() - t0, 6)
        self.recovered = store.revision > 0
        self.recovery_info = info
        if self.recovered:
            logger.info(
                "recovered store at revision %d (checkpoint rev %d, %d WAL "
                "records, %d torn) in %.3fs", store.revision,
                info["checkpoint_revision"], info["replayed_records"],
                info["torn_records"], info["total_s"])
        return store

    def _load_checkpoint(self, store: TupleStore, manifest: dict,
                         info: dict) -> None:
        path = os.path.join(self.ckpt_dir, manifest["checkpoint"])
        snap, overlay, meta = ckpt.load_columnar_file(path)
        # wholesale adoption at EXACTLY the manifest revision — loading
        # base + overlay as separate revision-bumping steps would strand
        # low-revision checkpoints (e.g. rev 1 with a caveated overlay)
        store.adopt_recovery_state(snap if len(snap) else None, overlay,
                                   int(manifest["revision"]))
        info["checkpoint_revision"] = int(manifest["revision"])
        info["checkpoint_tuples"] = len(snap) + len(overlay)
        self._last_ckpt_revision = int(manifest["revision"])
        self._last_ckpt_unix = manifest.get("created_unix")

    def _replay_wal(self, store: TupleStore, info: dict) -> None:
        for rec in self.wal.replay():
            rev = int(rec["r"])
            if rev <= store.revision:
                continue  # covered by the checkpoint
            if rev != store.revision + 1:
                raise WalCorruptionError(
                    f"revision gap in WAL: store at {store.revision}, "
                    f"next record {rev}")
            kind = rec["k"]
            if kind == "d":
                updates = [
                    RelationshipUpdate(
                        UpdateOp.DELETE if op == "d" else UpdateOp.TOUCH,
                        parse_relationship(s))
                    for op, s in rec.get("u", ())]
                store.apply_recovery_batch(updates)
                info["replayed_updates"] += len(updates)
                info["idempotency_keys"] += len(rec.get("i", ()))
            elif kind == "s":
                snap, overlay, _ = ckpt.load_columnar_file(
                    os.path.join(self.wal.dir, rec["f"]))
                store.bulk_load_snapshot(snap)
                info["replayed_updates"] += len(snap) + len(overlay)
            elif kind == "b":
                rels = [parse_relationship(s) for s in rec.get("u", ())]
                store.bulk_load(rels)
                info["replayed_updates"] += len(rels)
            elif kind == "c":
                store.delete_all()
            else:
                raise WalCorruptionError(f"unknown WAL record kind {kind!r}")
            if store.revision != rev:
                raise WalCorruptionError(
                    f"replay of kind {kind!r} landed at revision "
                    f"{store.revision}, record says {rev}")
            info["replayed_records"] += 1

    # -- journaling ----------------------------------------------------------

    def attach(self, store: TupleStore) -> None:
        """Start journaling `store`'s commits.  Attach BEFORE applying
        bootstrap data so the bootstrap itself is durable."""
        if self._store is not None:
            raise RuntimeError("already attached")
        self._store = store
        store.add_commit_listener(self._on_commit)

    def detach(self) -> None:
        if self._store is not None:
            self._store.remove_commit_listener(self._on_commit)
            self._store = None

    def _on_commit(self, kind: str, revision: int, payload) -> None:
        # runs synchronously under the store lock (store.py `_commit`)
        if self._wal_failed:
            raise PersistenceUnavailableError(
                "a previous WAL append failed; refusing further writes "
                "(the failed append may or may not be on disk, so its "
                "revision cannot be reused — restart to re-derive the "
                "truth from the log)")
        try:
            self._journal_commit(kind, revision, payload)
        except FailPointPanic:
            raise  # simulated crash: the test abandons this process
        except Exception:
            # the commit aborts un-applied (the store journals before
            # mutating), but a complete frame for `revision` may still
            # sit on disk: re-issuing that revision with different
            # state would make replay silently skip it — fail stop
            self._wal_failed = True
            logger.exception(
                "WAL append failed at revision %d; store is no longer "
                "durable, refusing further writes", revision)
            raise

    def _journal_commit(self, kind: str, revision: int, payload) -> None:
        if kind == "delta":
            ops = []
            idem = []
            for u in payload:
                delete = u.op == UpdateOp.DELETE
                ops.append(["d" if delete else "t", u.rel.rel_string()])
                if (not delete and u.rel.resource.type == _IDEM_TYPE
                        and u.rel.relation == _IDEM_RELATION):
                    idem.append(u.rel.subject.id)
            rec = {"k": "d", "r": revision, "u": ops}
            if idem:
                rec["i"] = idem
        elif kind == "snapshot":
            fname = f"snap-{revision:012d}.npz"
            self._save_sidecar(payload, fname)
            rec = {"k": "s", "r": revision, "f": fname}
        elif kind == "bulk":
            rec = {"k": "b", "r": revision,
                   "u": [r.rel_string() for r in payload]}
        elif kind == "clear":
            rec = {"k": "c", "r": revision}
        else:  # pragma: no cover - future store commit kinds
            raise ValueError(f"unknown commit kind {kind!r}")
        self.wal.append(json.dumps(rec, separators=(",", ":")).encode(),
                        kind=kind)

    def _save_sidecar(self, snap: ColumnarSnapshot, fname: str) -> None:
        """Persist a bulk-loaded snapshot next to the WAL; written and
        fsynced BEFORE the record referencing it, so a record present in
        the stream implies a readable sidecar."""
        cols = {name: getattr(snap, name) for name in _COLS}
        ckpt.save_columnar_file(
            os.path.join(self.wal.dir, fname), snap.pool, cols,
            snap.expiry, overlay=[], meta={"revision": 0})

    # -- checkpoints ---------------------------------------------------------

    def checkpoint(self) -> Optional[dict]:
        """One checkpoint cycle: capture the store state + seal the WAL
        under the store lock, serialize outside it, publish the manifest
        atomically, reclaim covered segments.  Returns the manifest, or
        None when the store hasn't advanced since the last checkpoint."""
        store = self._store
        if store is None:
            raise RuntimeError("not attached to a store")
        with self._ckpt_lock:
            if store.revision in (0, self._last_ckpt_revision):
                # nothing new: no timer observation — the histogram must
                # only measure real cycles or its mean collapses to the
                # no-op cost on idle stores (revisions only grow, so the
                # re-read under the store lock below stays != last)
                return None
            return self._checkpoint_locked(store)

    def _checkpoint_locked(self, store: TupleStore) -> dict:
        with m.Timer(self._ckpt_hist):
            with store.lock:
                revision = store.revision
                view = store.columnar_view()
                rels = None if view is not None else store.read(None)
                watermark = self.wal.cut()
            # serialization runs OUTSIDE the store lock: the snapshot
            # arrays are immutable and the captured row indices / overlay
            # list are private copies, so writers proceed concurrently
            if view is not None:
                snap, rows, overlay = view
                cols = {name: getattr(snap, name)[rows] for name in _COLS}
                expiry = snap.expiry[rows]
                pool = snap.pool
                overlay_strings = [r.rel_string() for r in overlay]
            else:
                plain = [r for r in rels if r.caveat is None]
                overlay_strings = [r.rel_string() for r in rels
                                   if r.caveat is not None]
                csnap = ColumnarSnapshot.from_relationships(plain)
                cols = {name: getattr(csnap, name) for name in _COLS}
                expiry = csnap.expiry
                pool = csnap.pool
            fname = ckpt.checkpoint_name(revision)
            ckpt.save_columnar_file(
                os.path.join(self.ckpt_dir, fname), pool, cols,
                np.asarray(expiry, dtype=np.float64), overlay_strings,
                meta={"revision": revision, "watermark": watermark},
                failpoint="checkpointBeforeRename")
            manifest = ckpt.default_manifest(revision, fname, watermark)
            ckpt.write_manifest(self.data_dir, manifest,
                                failpoint="manifestBeforeRename")
            self._last_ckpt_revision = revision
            self._last_ckpt_unix = manifest["created_unix"]
            self._ckpt_total.inc()
            self._reclaim(fname, watermark, revision)
        logger.info("checkpoint at revision %d (watermark seg %d)",
                    revision, watermark)
        return manifest

    def _reclaim(self, current_ckpt: str, watermark: int,
                 revision: int) -> None:
        self.wal.reclaim(watermark, revision)
        for name in os.listdir(self.ckpt_dir):
            if name != current_ckpt and (name.startswith("ckpt-")
                                         or name.endswith(".tmp")):
                try:
                    os.unlink(os.path.join(self.ckpt_dir, name))
                except OSError:
                    pass

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        """Start the periodic checkpoint loop and (for the `interval`
        fsync policy) the idle-flush task that bounds the loss window
        when no further append arrives to trigger the fsync."""
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._loop())
        if (self.wal.fsync_policy == FSYNC_INTERVAL
                and (self._flush_task is None or self._flush_task.done())):
            self._flush_task = asyncio.ensure_future(self._flush_loop())

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.wal.fsync_interval)
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.wal.fsync_if_dirty)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("idle WAL fsync failed")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.checkpoint_interval)
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.checkpoint)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("periodic checkpoint failed")

    async def stop(self, final_checkpoint: bool = True) -> None:
        for attr in ("_task", "_flush_task"):
            task = getattr(self, attr)
            setattr(self, attr, None)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        if final_checkpoint and self._store is not None:
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.checkpoint)
            except Exception:
                logger.exception("final checkpoint failed")
        self.close()

    def close(self) -> None:
        """Detach + close the WAL (clean shutdown; crash tests simply
        abandon the manager instead)."""
        self.detach()
        self.wal.close()
