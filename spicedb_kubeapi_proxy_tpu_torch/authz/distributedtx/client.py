"""Workflow engine setup (reference pkg/authz/distributedtx/client.go;
this package's reference authz/distributedtx/client.py:18-39):
SQLite-file or in-memory journal, monoprocess worker, registers the two
workflows and the activities."""

from __future__ import annotations


from ...proxy.httpcore import Transport
from ...spicedb.endpoints import PermissionsEndpoint
from .activity import ActivityHandler
from .engine import WorkflowEngine
from .journal import MemoryJournal, SQLiteJournal
from .workflow import (
    STRATEGY_PESSIMISTIC,
    WORKFLOWS)


def setup_workflow_engine(endpoint: PermissionsEndpoint,
                          kube_transport: Transport,
                          database_path: str = "",
                          default_lock_mode: str = STRATEGY_PESSIMISTIC,
                          audit=None) -> tuple:
    """Returns (engine-as-client, engine-as-worker); the caller starts the
    worker (reference SetupWithSQLiteBackend / SetupWithMemoryBackend).
    `audit` (utils/audit.AuditSink) receives one dual-write decision
    event per completed workflow instance."""
    from ...utils.audit import NULL_SINK
    journal = SQLiteJournal(database_path) if database_path else MemoryJournal()
    engine = WorkflowEngine(journal, audit=audit if audit is not None
                            else NULL_SINK)
    handler = ActivityHandler(endpoint, kube_transport)
    engine.register_activity("write_to_spicedb", handler.write_to_spicedb)
    engine.register_activity("read_relationships", handler.read_relationships)
    engine.register_activity("write_to_kube", handler.write_to_kube)
    engine.register_activity("check_kube_resource", handler.check_kube_resource)
    for name, fn in WORKFLOWS.items():
        engine.register_workflow(name, fn)
    engine.default_lock_mode = default_lock_mode  # type: ignore[attr-defined]
    return engine, engine
