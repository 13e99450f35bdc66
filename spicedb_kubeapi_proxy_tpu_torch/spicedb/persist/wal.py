"""Segmented append-only write-ahead log for the tuple store.

Each committed store mutation (delta write, bulk load, delete-all) becomes
one CRC-framed, revision-stamped record appended synchronously under the
store lock, so the on-disk stream totally orders every revision the
in-memory store ever produced.  Records live in numbered segment files;
sealed segments are immutable and become reclaimable once a checkpoint's
revision covers them (manager.py).

Frame format (little-endian), after an 8-byte per-segment magic:

    [u32 payload_len][u32 crc32(payload)][payload bytes]

The payload is compact JSON (see manager.py for the record vocabulary).
Replay tolerates a torn FINAL record — a crash mid-append — by truncating
the tail at the last whole frame; a bad frame anywhere else is real
corruption and raises `WalCorruptionError` rather than silently dropping
committed revisions.

Fsync policy is configurable (`always` | `interval` | `never`): `always`
makes every acked write durable before the caller resumes, `interval` bounds the loss window, `never` leaves
durability to the OS cache.  Appends always flush the Python buffer, so
an in-process "crash" (abandoning the writer) loses nothing that replay
could have seen.

Single-writer: one process appends to a data dir at a time (the proxy's
deployment owns the volume; there is no lock file).
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

from ...utils import metrics as m
from ...utils.failpoints import fail_point

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.persist")

SEGMENT_MAGIC = b"SPWAL001"
_FRAME = struct.Struct("<II")
_SEG_RE = re.compile(r"^seg-(\d{8})\.wal$")

FSYNC_ALWAYS = "always"
FSYNC_INTERVAL = "interval"
FSYNC_NEVER = "never"
FSYNC_POLICIES = (FSYNC_ALWAYS, FSYNC_INTERVAL, FSYNC_NEVER)

DEFAULT_SEGMENT_BYTES = 8 << 20

# checkpoint/fsync work spans ms..minutes; the default latency buckets
# top out at 10s
_IO_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
               1.0, 5.0, 15.0, 60.0)


class WalCorruptionError(Exception):
    """A non-tail frame failed its CRC/length check, or the record stream
    has a revision gap: committed state cannot be reconstructed."""


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def segment_name(seq: int) -> str:
    return f"seg-{seq:08d}.wal"


class TornFrameError(Exception):
    """A frame in the middle of a byte stream failed its CRC/length check
    (parse_frames): the stream is damaged beyond a torn tail."""


def parse_frames(data: bytes, offset: int = 0) -> tuple:
    """Parse complete CRC frames out of `data[offset:]` -> (records,
    consumed) where `consumed` is the offset just past the last WHOLE
    valid frame.  A truncated FINAL frame (torn tail / still-being-
    written segment) stops the parse cleanly; a bad frame followed by
    more bytes raises TornFrameError.  This is the ONE frame decoder:
    segment replay (SegmentedWal._replay_segment below) and replication
    followers parsing segment bytes fetched over HTTP
    (spicedb/replication/follower.py) both call it, so leader recovery
    and follower tailing can never disagree on framing."""
    records = []
    off = offset
    n = len(data)
    while off < n:
        if off + _FRAME.size > n:
            break  # torn header: wait for more bytes
        length, crc = _FRAME.unpack_from(data, off)
        start, end = off + _FRAME.size, off + _FRAME.size + length
        if end > n:
            break  # torn payload
        bad = None
        if zlib.crc32(data[start:end]) != crc:
            bad = "crc mismatch"
        else:
            try:
                rec = json.loads(data[start:end])
            except ValueError:
                rec = None
            if not isinstance(rec, dict) or "k" not in rec or "r" not in rec:
                bad = "undecodable record"
        if bad is not None:
            if end == n:
                break  # torn tail shape: retry once more bytes arrive
            raise TornFrameError(f"frame at offset {off}: {bad}")
        records.append(rec)
        off = end
    return records, off


# owned by PersistenceManager, which only exists under the DURABLE_STORE
# switch: with it off no WAL is opened, so nothing here can tick
class SegmentedWal:
    """Append/replay over the `wal/` directory of a data dir.

    Thread safety is the owning store's lock: appends happen from commit
    listeners that already run under it; replay happens before any
    listener is attached.
    """

    def __init__(self, wal_dir: str,
                 fsync: str = FSYNC_INTERVAL,
                 fsync_interval: float = 1.0,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 registry: Optional[m.Registry] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r}; expected one of "
                f"{FSYNC_POLICIES}")
        self.dir = wal_dir
        self.fsync_policy = fsync
        self.fsync_interval = fsync_interval
        self.segment_bytes = segment_bytes
        os.makedirs(wal_dir, exist_ok=True)
        existing = self.segment_seqs()
        self._next_seq = (existing[-1] + 1) if existing else 1
        self._cur_seq = 0
        self._cur_file = None
        self._cur_bytes = 0
        self._last_fsync = time.monotonic()
        # appends are serialized by the store lock, but the idle-flush
        # task (manager.py) fsyncs from the event loop: seal/fsync of the
        # open segment must not race a concurrent close
        self._io_lock = threading.Lock()
        self._dirty = False
        # replay repair accounting (surfaced in recovery_info)
        self.torn_records = 0
        registry = registry or m.REGISTRY
        self._append_hist = registry.histogram(
            "authz_wal_append_seconds",
            "Write-ahead-log record append latency (excluding fsync)")
        self._fsync_hist = registry.histogram(
            "authz_wal_fsync_seconds",
            "Write-ahead-log fsync latency", buckets=_IO_BUCKETS)
        self._appends = registry.counter(
            "authz_wal_appends_total",
            "Write-ahead-log records appended, by record kind",
            labels=("kind",))

    # -- introspection -------------------------------------------------------

    def segment_seqs(self) -> list:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            mm = _SEG_RE.match(n)
            if mm:
                out.append(int(mm.group(1)))
        return sorted(out)

    def segment_count(self) -> int:
        return len(self.segment_seqs())

    def total_bytes(self) -> int:
        total = 0
        for seq in self.segment_seqs():
            try:
                total += os.path.getsize(self._path(seq))
            except OSError:
                pass
        return total

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, segment_name(seq))

    # -- append --------------------------------------------------------------

    def _open_segment(self) -> None:
        seq = self._next_seq
        self._next_seq += 1
        f = open(self._path(seq), "wb")
        f.write(SEGMENT_MAGIC)
        f.flush()
        if self.fsync_policy != FSYNC_NEVER:
            # make the segment's DIRECTORY ENTRY durable: without this a
            # power failure could drop the whole newest segment — and
            # with it acked fsync=always writes — with no gap to detect
            _fsync_dir(self.dir)
        self._cur_seq, self._cur_file, self._cur_bytes = \
            seq, f, len(SEGMENT_MAGIC)

    def append(self, payload: bytes, kind: str = "") -> None:
        """Append one record; called under the store lock.  An IOError or
        armed failpoint propagates to the writer — durability failures
        must fail the write, not pass silently."""
        fail_point("walBeforeAppend")
        if self._cur_file is None:
            self._open_segment()
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        t0 = time.perf_counter()
        self._cur_file.write(frame)
        self._cur_file.flush()
        self._append_hist.observe(time.perf_counter() - t0)
        self._appends.inc(kind=kind or "delta")
        self._cur_bytes += len(frame)
        self._dirty = True
        fail_point("walAfterAppend")
        self._maybe_fsync()
        if self._cur_bytes >= self.segment_bytes:
            self._seal_current()

    def _fsync_current_locked(self) -> None:
        # clear the dirty flag BEFORE fsync: an append racing the fsync
        # re-marks it, so its (possibly not-yet-synced) frame is caught
        # by the next flush instead of being skipped forever; clearing
        # after would swallow that append's mark
        self._dirty = False
        t0 = time.perf_counter()
        try:
            os.fsync(self._cur_file.fileno())
        except Exception:
            self._dirty = True
            raise
        self._fsync_hist.observe(time.perf_counter() - t0)
        self._last_fsync = time.monotonic()

    def _maybe_fsync(self) -> None:
        if self.fsync_policy == FSYNC_NEVER:
            return
        if (self.fsync_policy == FSYNC_INTERVAL
                and time.monotonic() - self._last_fsync < self.fsync_interval):
            return
        with self._io_lock:
            self._fsync_current_locked()

    def fsync_if_dirty(self) -> bool:
        """Fsync the open segment if it holds unfsynced appends — the
        idle-flush hook (manager.py) that bounds the `interval` policy's
        loss window even when no further append arrives."""
        if self.fsync_policy == FSYNC_NEVER or not self._dirty:
            return False
        with self._io_lock:
            if self._cur_file is None or not self._dirty:
                return False
            self._fsync_current_locked()
            return True

    def _seal_current(self) -> int:
        """Close the open segment (fsynced unless policy is `never`);
        returns its seq."""
        seq = self._cur_seq
        with self._io_lock:
            f = self._cur_file
            if f is not None:
                if self.fsync_policy != FSYNC_NEVER:
                    self._fsync_current_locked()
                f.close()
            self._cur_file = None
            self._cur_bytes = 0
            self._dirty = False
        return seq

    def cut(self) -> int:
        """Seal the open segment and return the highest sealed seq — the
        checkpoint watermark: every record appended so far lives in a
        segment <= this seq.  Called under the store lock together with
        the checkpoint's revision capture, so no record <= that revision
        can land in a later segment."""
        if self._cur_file is not None:
            return self._seal_current()
        return self._next_seq - 1

    def close(self) -> None:
        if self._cur_file is not None:
            self._seal_current()

    # -- replay --------------------------------------------------------------

    def replay(self) -> Iterator[dict]:
        """Yield decoded records across all segments in order.  A torn
        final record (crash mid-append) is repaired by truncation; bad
        frames anywhere else raise WalCorruptionError."""
        seqs = self.segment_seqs()
        for i, seq in enumerate(seqs):
            yield from self._replay_segment(seq, final=(i == len(seqs) - 1))

    def _replay_segment(self, seq: int, final: bool) -> Iterator[dict]:
        path = self._path(seq)
        with open(path, "rb") as f:
            data = f.read()
        if len(data) == 0:
            # a crash between segment creation and the magic write (or a
            # prior header repair) leaves an empty file: no records, not
            # corruption — even when later segments follow it
            return
        if len(data) < len(SEGMENT_MAGIC) or not data.startswith(SEGMENT_MAGIC):
            if final:
                # torn segment creation: remove the file entirely so a
                # LATER restart (when this segment is no longer final)
                # doesn't read the remnant as corruption
                logger.warning("wal: torn segment header in %s; removing",
                               path)
                self.torn_records += 1
                os.unlink(path)
                _fsync_dir(self.dir)
                return
            raise WalCorruptionError(f"{path}: bad segment header")
        # the one shared frame decoder (parse_frames): a bad frame
        # reaching EOF stops the parse (torn-append shape), a bad frame
        # followed by more bytes raises — replay layers the repair
        # policy on top: a torn tail is repairable only at the end of
        # the LAST segment; anywhere else committed revisions are
        # damaged
        try:
            records, consumed = parse_frames(data, len(SEGMENT_MAGIC))
        except TornFrameError as e:
            raise WalCorruptionError(f"{path}: {e}") from e
        yield from records
        if consumed < len(data):
            if final:
                self._truncate(path, consumed, "torn or damaged final frame")
                return
            raise WalCorruptionError(
                f"{path}@{consumed}: torn frame in a sealed segment")

    def _truncate(self, path: str, offset: int, why: str) -> None:
        logger.warning("wal: torn final record in %s at offset %d (%s); "
                       "truncating", path, offset, why)
        self.torn_records += 1
        with open(path, "rb+") as f:
            f.truncate(offset)
            f.flush()
            os.fsync(f.fileno())

    # -- reclamation ---------------------------------------------------------

    def reclaim(self, watermark_seq: int, up_to_revision: int) -> int:
        """Delete sealed segments <= watermark_seq and snapshot sidecars
        <= up_to_revision (all covered by the durable checkpoint).  Never
        touches the open segment."""
        removed = 0
        for seq in self.segment_seqs():
            if seq > watermark_seq or seq == self._cur_seq and \
                    self._cur_file is not None:
                continue
            try:
                os.unlink(self._path(seq))
                removed += 1
            except OSError:
                pass
        for name in os.listdir(self.dir):
            mm = re.match(r"^snap-(\d{12})\.npz$", name)
            if mm and int(mm.group(1)) <= up_to_revision:
                try:
                    os.unlink(os.path.join(self.dir, name))
                    removed += 1
                except OSError:
                    pass
        if removed:
            _fsync_dir(self.dir)
        return removed
