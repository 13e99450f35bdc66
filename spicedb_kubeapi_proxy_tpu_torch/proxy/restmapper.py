"""Caching REST mapper: GVR -> GVK via upstream discovery.

Mirrors the reference's serialized, TTL-memoized discovery mapper
(pkg/proxy/restmapper.go:31-107): lookups are memoized per (group, version,
resource) with a TTL, errors are never cached, and concurrent access is
serialized.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass

from .httpcore import Headers, Request, Transport


class NoKindMatchError(Exception):
    def __init__(self, group: str, version: str, resource: str):
        super().__init__(f"no matches for {group}/{version}, resource={resource}")
        self.group, self.version, self.resource = group, version, resource


@dataclass(frozen=True)
class GroupVersionKind:
    group: str
    version: str
    kind: str

    @property
    def group_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version


DEFAULT_TTL = 300.0


class CachingRESTMapper:
    def __init__(self, transport: Transport, ttl: float = DEFAULT_TTL,
                 clock=time.monotonic):
        self._transport = transport
        self._ttl = ttl
        self._clock = clock
        self._cache: dict[tuple, tuple] = {}  # gvr -> (gvk, expires)
        self._lock = asyncio.Lock()

    async def kind_for(self, group: str, version: str, resource: str) -> GroupVersionKind:
        key = (group, version, resource)
        async with self._lock:  # discovery client is not concurrency-safe
            cached = self._cache.get(key)
            now = self._clock()
            if cached is not None and cached[1] > now:
                return cached[0]
            gvk = await self._discover(group, version, resource)
            # never cache errors (discover raises on failure)
            self._cache[key] = (gvk, now + self._ttl)
            return gvk

    async def _discover(self, group: str, version: str, resource: str) -> GroupVersionKind:
        path = (f"/apis/{group}/{version}" if group else f"/api/{version}")
        req = Request(method="GET", target=path, headers=Headers(
            [("Accept", "application/json")]))
        resp = await self._transport.round_trip(req)  # noqa: A006(external kube discovery)
        if resp.status != 200:
            raise NoKindMatchError(group, version, resource)
        try:
            doc = json.loads(resp.body)
        except ValueError as e:
            raise NoKindMatchError(group, version, resource) from e
        for r in doc.get("resources", []):
            if r.get("name") == resource:
                return GroupVersionKind(group=group, version=version,
                                        kind=r.get("kind", ""))
        raise NoKindMatchError(group, version, resource)
