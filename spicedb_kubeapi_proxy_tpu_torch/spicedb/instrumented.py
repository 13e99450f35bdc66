"""Endpoint-boundary instrumentation (SURVEY.md §5: check/LR latency and
batch-size metrics from day one).

Wraps any PermissionsEndpoint; upper layers keep speaking the endpoint
contract (the seam at reference pkg/proxy/options.go:307-369) while every
verb records latency, batch size, and errors.  Backend-internal stats (the
torch:// device-graph rebuild/delta/kernel counters) surface as scrape-time
gauges when the wrapped endpoint exposes `.stats`.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..utils import metrics as m
from .endpoints import PermissionsEndpoint
from .store import Watcher
from .types import (
    CheckRequest,
    Precondition,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectRef,
)


class InstrumentedEndpoint(PermissionsEndpoint):
    def __init__(self, inner: PermissionsEndpoint,
                 registry: Optional[m.Registry] = None,
                 backend_label: str = ""):
        self.inner = inner
        registry = registry or m.REGISTRY
        self.backend = backend_label or type(inner).__name__
        self.latency = registry.histogram(
            "authz_endpoint_latency_seconds",
            "Latency of permission-endpoint verbs", labels=("verb", "backend"))
        self.batch_size = registry.histogram(
            "authz_endpoint_batch_size",
            "Requests per endpoint call (checks per bulk, subjects per"
            " lookup batch)", labels=("verb", "backend"),
            buckets=m._DEFAULT_SIZE_BUCKETS)
        self.errors = registry.counter(
            "authz_endpoint_errors_total",
            "Errors raised by permission-endpoint verbs",
            labels=("verb", "backend"))
        stats = getattr(inner, "stats", None)
        if isinstance(stats, dict):
            import weakref

            # weakref so a registry-held gauge callback never pins a
            # replaced endpoint (and its device arrays) alive; when several
            # endpoints coexist, the most recently constructed one wins
            ref = weakref.ref(inner)
            for key in stats:
                registry.gauge(
                    f"authz_backend_{key}_total",
                    f"backend counter: {key.replace('_', ' ')}",
                    callback=(lambda k=key: float(
                        (getattr(ref(), "stats", None) or {}).get(k, 0))))

    # -- helpers -------------------------------------------------------------

    async def _timed(self, verb: str, size: int, coro):
        self.batch_size.observe(size, verb=verb, backend=self.backend)
        try:
            with m.Timer(self.latency, verb=verb, backend=self.backend):
                return await coro
        except Exception:
            self.errors.inc(verb=verb, backend=self.backend)
            raise

    # -- verbs ---------------------------------------------------------------

    async def check_permission(self, req: CheckRequest):
        return await self._timed("check", 1, self.inner.check_permission(req))

    async def check_bulk_permissions(self, reqs: list) -> list:
        return await self._timed("check_bulk", len(reqs),
                                 self.inner.check_bulk_permissions(reqs))

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject: SubjectRef) -> list:
        return await self._timed("lookup_resources", 1,
                                 self.inner.lookup_resources(
                                     resource_type, permission, subject))

    async def lookup_resources_batch(self, resource_type: str, permission: str,
                                     subjects: list) -> list:
        return await self._timed("lookup_resources_batch", len(subjects),
                                 self.inner.lookup_resources_batch(
                                     resource_type, permission, subjects))

    async def read_relationships(self, flt: RelationshipFilter) -> list:
        return await self._timed("read_relationships", 1,
                                 self.inner.read_relationships(flt))

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()) -> int:
        ups = list(updates)
        return await self._timed("write_relationships", len(ups),
                                 self.inner.write_relationships(
                                     ups, preconditions))

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()) -> int:
        return await self._timed("delete_relationships", 1,
                                 self.inner.delete_relationships(
                                     flt, preconditions))

    def watch(self, object_types=None) -> Watcher:
        return self.inner.watch(object_types)

    async def close(self) -> None:
        await self.inner.close()

    def __getattr__(self, name):
        # store/schema/evaluator and backend-specific hooks pass through
        return getattr(self.inner, name)
