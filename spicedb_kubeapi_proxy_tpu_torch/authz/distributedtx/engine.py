"""Deterministic workflow runtime over the journal (this package's
reference authz/distributedtx/engine.py:42-297: the replay at :58-120,
the eager no-worker path at :129-154, the worker at :178-190 and the
instance audit at :249-292).

A focused equivalent of the go-workflows engine the reference embeds
(reference client.go:18-77): sequential workflows execute activities through
`WorkflowContext.execute_activity`, every completion is journaled, and on
crash (FailPointPanic or process restart) the instance re-runs from the top
with completed activities replayed from the journal — activities are
at-least-once, which is why the SpiceDB write activity carries idempotency
keys (reference activity.go:47-102).
"""

from __future__ import annotations

import asyncio
import json
import traceback
from typing import Any, Awaitable, Callable, Optional

from ...utils.audit import (
    AuditEvent,
    NULL_SINK,
    OUTCOME_ALLOWED,
    OUTCOME_DENIED,
    OUTCOME_ERROR,
)
from ...utils.failpoints import FailPointPanic
from ...utils.tracing import span
from . import journal as journal_mod
from .journal import Journal

DEFAULT_WORKFLOW_TIMEOUT = 30.0


class WorkflowError(Exception):
    pass


class ActivityError(Exception):
    """A journaled activity failure, replayed deterministically."""


class WorkflowContext:
    def __init__(self, instance_id: str, journal: Journal, activities: dict):
        self.instance_id = instance_id
        self._journal = journal
        self._activities = activities
        self._replay = journal.events(instance_id)
        self._seq = 0
        # out-of-band run annotations (NOT journaled): workflows record
        # rollback reasons here so the completion audit event can report
        # the rollback outcome; replayed (already-journaled) activities
        # re-record their notes because the workflow body re-runs
        self.notes: dict = {}

    async def execute_activity(self, name: str, *args: Any) -> Any:
        """Run (or replay) the next activity in the deterministic sequence."""
        seq = self._seq
        self._seq += 1
        if seq < len(self._replay):
            _, recorded_name, result, error = self._replay[seq]
            if recorded_name != name:
                raise WorkflowError(
                    f"non-deterministic replay: journal has {recorded_name!r}"
                    f" at seq {seq}, workflow asked for {name!r}")
            if error:
                raise ActivityError(error)
            return result
        fn = self._activities.get(name)
        if fn is None:
            raise WorkflowError(f"unknown activity {name!r}")
        try:
            # workflow step span: replayed completions above return
            # without one (they did no work this run)
            with span("workflow." + name):
                result = fn(*args)
                if asyncio.iscoroutine(result) or isinstance(result, Awaitable):
                    result = await result
        except FailPointPanic:
            # simulated crash: do NOT journal; replay will re-execute
            raise
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # journaled failure: deterministic on replay
            self._journal.record_event(self.instance_id, seq, name, None,
                                       error=str(e) or type(e).__name__)
            self._replay = self._journal.events(self.instance_id)
            raise ActivityError(str(e) or type(e).__name__) from e
        # results must round-trip through JSON (journal durability)
        result = json.loads(json.dumps(result))
        self._journal.record_event(self.instance_id, seq, name, result)
        self._replay = self._journal.events(self.instance_id)
        return result

    async def sleep(self, seconds: float) -> None:
        # journaled as a no-op activity so replay doesn't re-sleep
        seq = self._seq
        self._seq += 1
        if seq < len(self._replay):
            return
        await asyncio.sleep(seconds)
        self._journal.record_event(self.instance_id, seq, "__sleep__", None)
        self._replay = self._journal.events(self.instance_id)


Workflow = Callable[[WorkflowContext, dict], Awaitable[Optional[dict]]]


class WorkflowEngine:
    """Client + monoprocess worker (reference client.go:32-77)."""

    def __init__(self, journal: Journal, max_crash_replays: int = 50,
                 audit=NULL_SINK):
        self.journal = journal
        self._workflows: dict[str, Workflow] = {}
        self._activities: dict[str, Callable] = {}
        self._wakeup = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._done_events: dict[str, asyncio.Event] = {}
        self.max_crash_replays = max_crash_replays
        self.audit = audit
        # strong refs to eagerly-launched instance tasks: the event loop
        # holds tasks only weakly, so a fire-and-forget ensure_future is
        # collectable by the cyclic gc MID-FLIGHT — the instance then
        # hangs forever and its waiter times out ("Task was destroyed
        # but it is pending").  Latent since the eager path existed; it
        # surfaces whenever allocation churn lands a gen-2 collection
        # inside the workflow window.
        self._eager_tasks: set = set()

    # -- registration --------------------------------------------------------

    def register_workflow(self, name: str, fn: Workflow) -> None:
        self._workflows[name] = fn

    def register_activity(self, name: str, fn: Callable) -> None:
        self._activities[name] = fn

    # -- client --------------------------------------------------------------

    def create_instance(self, instance_id: str, workflow: str, input: dict) -> str:
        if workflow not in self._workflows:
            raise WorkflowError(f"unknown workflow {workflow!r}")
        self.journal.create_instance(instance_id, workflow, input)
        self._done_events[instance_id] = asyncio.Event()
        if self._task is None:
            # no polling worker: execute eagerly in this loop (keeping a
            # strong reference — see _eager_tasks)
            task = asyncio.ensure_future(self._run_instance(instance_id))
            self._eager_tasks.add(task)
            task.add_done_callback(self._eager_tasks.discard)
        else:
            self._wakeup.set()
        return instance_id

    async def get_result(self, instance_id: str,
                         timeout: float = DEFAULT_WORKFLOW_TIMEOUT) -> dict:
        event = self._done_events.get(instance_id)
        rec = self.journal.get_instance(instance_id)
        if rec is None:
            raise WorkflowError(f"unknown instance {instance_id!r}")
        if rec.status == journal_mod.STATUS_PENDING:
            if event is None:
                raise WorkflowError(f"instance {instance_id!r} has no waiter")
            try:
                await asyncio.wait_for(event.wait(), timeout)
            except asyncio.TimeoutError:
                raise WorkflowError(
                    f"timed out waiting for workflow {instance_id}") from None
            rec = self.journal.get_instance(instance_id)
        self._done_events.pop(instance_id, None)
        if rec.status == journal_mod.STATUS_FAILED:
            raise WorkflowError(rec.error or "workflow failed")
        return rec.result or {}

    # -- worker --------------------------------------------------------------

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def run_pending_once(self) -> int:
        """Drain all pending instances (also used for crash-recovery tests
        and at startup to resume in-flight dual writes)."""
        count = 0
        for instance_id in self.journal.pending_instances():
            await self._run_instance(instance_id)
            count += 1
        return count

    async def _run(self) -> None:
        cycles = 0
        while True:
            await self.run_pending_once()
            cycles += 1
            if cycles % 120 == 0:
                self.journal.prune_completed()
            self._wakeup.clear()
            try:
                await asyncio.wait_for(self._wakeup.wait(), 0.5)
            except asyncio.TimeoutError:
                pass

    async def _run_instance(self, instance_id: str) -> None:
        rec = self.journal.get_instance(instance_id)
        if rec is None or rec.status != journal_mod.STATUS_PENDING:
            return
        fn = self._workflows.get(rec.workflow)
        if fn is None:
            self.journal.complete_instance(
                instance_id, None, error=f"unknown workflow {rec.workflow!r}")
            self._signal(instance_id)
            return
        ctx = None
        while True:
            ctx = WorkflowContext(instance_id, self.journal, self._activities)
            try:
                result = await fn(ctx, rec.input)
            except FailPointPanic:
                # simulated crash: replay the instance (journal intact)
                attempts = self.journal.bump_attempts(instance_id)
                if attempts > self.max_crash_replays:
                    self.journal.complete_instance(
                        instance_id, None,
                        error="workflow exceeded crash-replay budget")
                    break
                continue
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.journal.complete_instance(
                    instance_id, None,
                    error=f"workflow had a panic: {e}\n{traceback.format_exc()}")
                break
            self.journal.complete_instance(instance_id, result)
            break
        self._audit_instance(instance_id, ctx)
        self._signal(instance_id)

    def _audit_instance(self, instance_id: str, ctx) -> None:
        """Dual-write decision audit: one event per completed instance —
        committed / rolled-back (kube 409 etc.) / failed — with any
        rollback reasons the workflow noted."""
        if not self.audit.enabled:
            return
        rec = self.journal.get_instance(instance_id)
        if rec is None:
            return
        input = rec.input or {}
        result = rec.result or {}
        notes = list((getattr(ctx, "notes", None) or {}).get("rollbacks", ()))
        code = result.get("status_code", 0)
        if rec.status == journal_mod.STATUS_FAILED:
            decision = OUTCOME_ERROR
            message = (rec.error or "workflow failed").splitlines()[0]
            if notes:
                message += "; " + "; ".join(notes)
        elif notes or (code and code >= 400):
            # the write did NOT land as requested: SpiceDB conflict
            # surfaced as kube 409, or a kube failure forced a rollback
            decision = OUTCOME_DENIED
            message = "; ".join(notes) if notes else f"status {code}"
        else:
            decision, message = OUTCOME_ALLOWED, ""
        from ...utils import tracing
        tr = tracing.current_trace()
        name = input.get("object_name") or input.get("request_name") or ""
        if message:
            message = f"instance {instance_id}: {message}"
        self.audit.emit(AuditEvent(
            stage="dualwrite", decision=decision,
            user=input.get("user_name", ""),
            verb=input.get("verb", ""),
            api_group=input.get("api_group", ""),
            resource=input.get("resource", ""),
            names=(name,) if name else (), count=1,
            rule=rec.workflow,
            backend=getattr(self.audit, "backend", ""),
            # prefer the journaled originating trace id: crash-recovery
            # replays complete outside any live request context
            trace_id=(input.get("trace_id", "")
                      or getattr(tr, "trace_id", "")),
            message=message))

    def _signal(self, instance_id: str) -> None:
        event = self._done_events.get(instance_id)
        if event is not None:
            event.set()
