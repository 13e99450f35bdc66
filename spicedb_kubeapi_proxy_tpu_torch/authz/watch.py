"""SpiceDB-side watch bridge (reference pkg/authz/watch.go).

Watches the tuple store for updates on the prefilter's resource type; each
update triggers a CheckPermission for the watching subject and pushes an
allow/revoke change keyed by NamespacedName into the tracker consumed by
the watch response filterer.

Filtering accounting: watch filtering used to be entirely silent — a
denied check or a dropped frame left no counter anywhere.
`authz_watch_events_filtered_total{resource=}` counts two DISJOINT
series: denied per-update checks here (labeled by the SpiceDB resource
type, e.g. `pod`) and definitively-dropped frames in the response
filterer (revocation of a buffered frame, buffer overflow, undecodable
frames — labeled by the kube resource, e.g. `pods`).  Buffering alone is
not counted: a buffered frame may still be delivered by a later grant.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ..rules.engine import ResolveInput, ResolvedPreFilter
from ..spicedb.endpoints import PermissionsEndpoint
from ..spicedb.types import CheckRequest, ObjectRef, SubjectRef
from ..utils.metrics import REGISTRY
from .lookups import extract_namespaced_name

# one counter, two increment sites (see module docstring); the label is
# a resource name — bounded by the schema/rules, never an identity
WATCH_FILTERED_TOTAL = REGISTRY.counter(
    "authz_watch_events_filtered_total",
    "Watch events filtered away from clients (denied update checks and "
    "dropped/withheld frames), by resource",
    labels=("resource",))


@dataclass
class ResultChange:
    allowed: bool
    namespace: str
    name: str


@dataclass
class WatchTracker:
    changes: asyncio.Queue = field(default_factory=asyncio.Queue)


async def run_watch(endpoint: PermissionsEndpoint, tracker: WatchTracker,
                    config: ResolvedPreFilter, input: ResolveInput,
                    watcher=None) -> None:
    """Long-lived store watch -> per-update check -> tracker change
    (reference watch.go:27-111).

    `watcher` should be subscribed by the caller BEFORE scheduling this
    coroutine, so tuple writes racing the watch setup are not lost."""
    if watcher is None:
        watcher = endpoint.watch([config.rel.resource_type])
    try:
        while True:
            # push-based: the store/stream wakes this coroutine directly
            # (WatchQueue.next) — no executor thread, no poll interval
            update = await watcher.next()
            if update is None:
                return  # closed and drained
            for u in update.updates:
                resource_id = u.rel.resource.id
                result = await endpoint.check_permission(CheckRequest(
                    resource=ObjectRef(config.rel.resource_type, resource_id),
                    permission=config.rel.resource_relation,
                    subject=SubjectRef(config.rel.subject_type,
                                       config.rel.subject_id,
                                       config.rel.subject_relation),
                ))
                if not result.allowed:
                    WATCH_FILTERED_TOTAL.inc(
                        resource=config.rel.resource_type)
                namespace, name = extract_namespaced_name(
                    config, input, resource_id, u.rel.subject.id)
                await tracker.changes.put(ResultChange(
                    allowed=result.allowed, namespace=namespace, name=name))
    except asyncio.CancelledError:
        raise
    finally:
        watcher.close()
