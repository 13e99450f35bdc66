"""Durable workflow journal: SQLite file or in-memory (this package's
reference authz/distributedtx/journal.py:36-247, unchanged in behaviour).

The event-sourced store behind the dual-write engine (reference uses
go-workflows with a SQLite backend, pkg/authz/distributedtx/client.go:18-30).
Every activity completion is journaled; on crash the instance replays and
completed activities return their recorded results instead of re-executing.
The journal file is the proxy's only durable state (SURVEY.md §5
checkpoint/resume).
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

STATUS_PENDING = "pending"
STATUS_COMPLETED = "completed"
STATUS_FAILED = "failed"


@dataclass
class InstanceRecord:
    instance_id: str
    workflow: str
    input: dict
    status: str
    result: Optional[dict] = None
    error: str = ""
    attempts: int = 0


class Journal:
    """Interface; see SQLiteJournal / MemoryJournal."""

    def create_instance(self, instance_id: str, workflow: str, input: dict) -> None:
        raise NotImplementedError

    def get_instance(self, instance_id: str) -> Optional[InstanceRecord]:
        raise NotImplementedError

    def pending_instances(self) -> list:
        raise NotImplementedError

    def record_event(self, instance_id: str, seq: int, activity: str,
                     result: Any, error: str = "") -> None:
        raise NotImplementedError

    def events(self, instance_id: str) -> list:
        """[(seq, activity, result, error)] ordered by seq."""
        raise NotImplementedError

    def complete_instance(self, instance_id: str, result: Optional[dict],
                          error: str = "") -> None:
        raise NotImplementedError

    def bump_attempts(self, instance_id: str) -> int:
        raise NotImplementedError

    def prune_completed(self, keep_last: int = 1000) -> None:
        """Drop all but the most recent `keep_last` finished instances so
        the journal (the proxy's only durable state) doesn't grow without
        bound with total request count."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SQLiteJournal(Journal):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("""
            CREATE TABLE IF NOT EXISTS instances (
                instance_id TEXT PRIMARY KEY,
                workflow TEXT NOT NULL,
                input TEXT NOT NULL,
                status TEXT NOT NULL,
                result TEXT,
                error TEXT DEFAULT '',
                attempts INTEGER DEFAULT 0,
                created REAL
            )""")
        self._conn.execute("""
            CREATE TABLE IF NOT EXISTS events (
                instance_id TEXT NOT NULL,
                seq INTEGER NOT NULL,
                activity TEXT NOT NULL,
                result TEXT,
                error TEXT DEFAULT '',
                PRIMARY KEY (instance_id, seq)
            )""")
        self._conn.commit()

    def create_instance(self, instance_id: str, workflow: str, input: dict) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO instances (instance_id, workflow, input, status,"
                " created) VALUES (?, ?, ?, ?, ?)",
                (instance_id, workflow, json.dumps(input), STATUS_PENDING,
                 time.time()))
            self._conn.commit()

    def get_instance(self, instance_id: str) -> Optional[InstanceRecord]:
        with self._lock:
            row = self._conn.execute(
                "SELECT instance_id, workflow, input, status, result, error,"
                " attempts FROM instances WHERE instance_id = ?",
                (instance_id,)).fetchone()
        if row is None:
            return None
        return InstanceRecord(
            instance_id=row[0], workflow=row[1], input=json.loads(row[2]),
            status=row[3], result=json.loads(row[4]) if row[4] else None,
            error=row[5] or "", attempts=row[6])

    def pending_instances(self) -> list:
        with self._lock:
            rows = self._conn.execute(
                "SELECT instance_id FROM instances WHERE status = ?"
                " ORDER BY created", (STATUS_PENDING,)).fetchall()
        return [r[0] for r in rows]

    def record_event(self, instance_id: str, seq: int, activity: str,
                     result: Any, error: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO events (instance_id, seq, activity,"
                " result, error) VALUES (?, ?, ?, ?, ?)",
                (instance_id, seq, activity, json.dumps(result), error))
            self._conn.commit()

    def events(self, instance_id: str) -> list:
        with self._lock:
            rows = self._conn.execute(
                "SELECT seq, activity, result, error FROM events WHERE"
                " instance_id = ? ORDER BY seq", (instance_id,)).fetchall()
        return [(r[0], r[1], json.loads(r[2]) if r[2] else None, r[3] or "")
                for r in rows]

    def complete_instance(self, instance_id: str, result: Optional[dict],
                          error: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE instances SET status = ?, result = ?, error = ?"
                " WHERE instance_id = ?",
                (STATUS_FAILED if error else STATUS_COMPLETED,
                 json.dumps(result) if result is not None else None,
                 error, instance_id))
            self._conn.commit()

    def bump_attempts(self, instance_id: str) -> int:
        with self._lock:
            self._conn.execute(
                "UPDATE instances SET attempts = attempts + 1 WHERE"
                " instance_id = ?", (instance_id,))
            self._conn.commit()
            row = self._conn.execute(
                "SELECT attempts FROM instances WHERE instance_id = ?",
                (instance_id,)).fetchone()
        return row[0] if row else 0

    def prune_completed(self, keep_last: int = 1000) -> None:
        with self._lock:
            rows = self._conn.execute(
                "SELECT instance_id FROM instances WHERE status != ?"
                " ORDER BY created DESC", (STATUS_PENDING,)).fetchall()
            victims = [r[0] for r in rows[keep_last:]]
            for instance_id in victims:
                self._conn.execute("DELETE FROM events WHERE instance_id = ?",
                                   (instance_id,))
                self._conn.execute(
                    "DELETE FROM instances WHERE instance_id = ?",
                    (instance_id,))
            if victims:
                self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class MemoryJournal(Journal):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instances: dict[str, InstanceRecord] = {}
        self._events: dict[str, list] = {}
        self._order: list = []

    def create_instance(self, instance_id: str, workflow: str, input: dict) -> None:
        with self._lock:
            self._instances[instance_id] = InstanceRecord(
                instance_id=instance_id, workflow=workflow, input=input,
                status=STATUS_PENDING)
            self._order.append(instance_id)

    def get_instance(self, instance_id: str) -> Optional[InstanceRecord]:
        with self._lock:
            rec = self._instances.get(instance_id)
            if rec is None:
                return None
            return InstanceRecord(**vars(rec))

    def pending_instances(self) -> list:
        with self._lock:
            return [i for i in self._order
                    if self._instances[i].status == STATUS_PENDING]

    def record_event(self, instance_id: str, seq: int, activity: str,
                     result: Any, error: str = "") -> None:
        with self._lock:
            events = self._events.setdefault(instance_id, [])
            events[:] = [e for e in events if e[0] != seq]
            events.append((seq, activity, json.loads(json.dumps(result)), error))
            events.sort(key=lambda e: e[0])

    def events(self, instance_id: str) -> list:
        with self._lock:
            return list(self._events.get(instance_id, []))

    def complete_instance(self, instance_id: str, result: Optional[dict],
                          error: str = "") -> None:
        with self._lock:
            rec = self._instances[instance_id]
            rec.status = STATUS_FAILED if error else STATUS_COMPLETED
            rec.result = result
            rec.error = error

    def bump_attempts(self, instance_id: str) -> int:
        with self._lock:
            rec = self._instances[instance_id]
            rec.attempts += 1
            return rec.attempts

    def prune_completed(self, keep_last: int = 1000) -> None:
        with self._lock:
            finished = [i for i in self._order
                        if self._instances[i].status != STATUS_PENDING]
            for instance_id in finished[:-keep_last] if keep_last else finished:
                self._instances.pop(instance_id, None)
                self._events.pop(instance_id, None)
                self._order.remove(instance_id)
