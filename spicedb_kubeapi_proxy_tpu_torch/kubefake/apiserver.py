"""Fake kube-apiserver fixture (this package's reference
kubefake/apiserver.py; lists are served off the event loop).

Stands in for controller-runtime envtest (which is Go-specific — SURVEY.md
§4 build translation): discovery documents, CRUD + resourceVersion
bookkeeping, label-selector list filtering, Table rendering, JSON watch
streams, merge patches, and gzip response encoding — enough surface for the
proxy's e2e tier to exercise every filtering and dual-write path.
"""

from __future__ import annotations

import asyncio
import copy
import gzip as gzip_mod
import json
import time
import uuid
from dataclasses import dataclass
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..proxy.httpcore import Headers, Request, Response, json_response
from ..proxy.kube import parse_request_info


@dataclass
class ResourceType:
    group: str
    version: str
    resource: str          # plural, e.g. "pods"
    kind: str              # e.g. "Pod"
    namespaced: bool = True
    short_names: tuple = ()

    @property
    def group_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version

    @property
    def list_kind(self) -> str:
        return self.kind + "List"


BUILTIN_TYPES = [
    ResourceType("", "v1", "namespaces", "Namespace", namespaced=False),
    ResourceType("", "v1", "pods", "Pod"),
    ResourceType("", "v1", "configmaps", "ConfigMap"),
    ResourceType("", "v1", "events", "Event"),
    ResourceType("", "v1", "secrets", "Secret"),
    ResourceType("", "v1", "services", "Service"),
    ResourceType("", "v1", "nodes", "Node", namespaced=False),
    ResourceType("apps", "v1", "deployments", "Deployment"),
]


def _status(code: int, reason: str, message: str, details: Optional[dict] = None) -> dict:
    return {
        "kind": "Status", "apiVersion": "v1", "metadata": {},
        "status": "Failure" if code >= 400 else "Success",
        "message": message, "reason": reason, "code": code,
        **({"details": details} if details else {}),
    }


def _match_label_selector(selector: str, labels: dict) -> bool:
    """Equality-based selectors: `k=v`, `k==v`, `k!=v`, comma-separated."""
    if not selector:
        return True
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            if labels.get(k.strip()) == v.strip():
                return False
        elif "==" in part:
            k, v = part.split("==", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        elif "=" in part:
            k, v = part.split("=", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        else:  # bare key: existence
            if part not in labels:
                return False
    return True


class FakeKubeApiServer:
    """An in-process kube-apiserver; also usable as a Handler directly."""

    def __init__(self, types: Optional[list] = None):
        self.types: dict[tuple, ResourceType] = {}
        for t in (types if types is not None else list(BUILTIN_TYPES)):
            self.register_type(t)
        # (group, version, resource) -> {namespace -> {name -> obj}}
        self.objects: dict[tuple, dict] = {}
        self._rv = 0
        self._watchers: dict[tuple, list] = {}  # gvr key -> [asyncio.Queue]
        self._lock = asyncio.Lock()
        # every write counts here; a list body stays cached, by (type,
        # namespace, selector, form), while the count stands
        self._writes = 0
        self._list_cache: dict = {}
        # the gzip encoding of a cached body, while the write count stands:
        # (writes, id(body)) -> (body, compressed)
        self._gzip_cache: dict = {}

    def register_type(self, t: ResourceType) -> None:
        self.types[(t.group, t.version, t.resource)] = t

    # -- helpers -------------------------------------------------------------

    def _next_rv(self) -> str:
        self._writes += 1
        self._rv += 1
        return str(self._rv)

    def _bucket(self, key: tuple, namespace: str) -> dict:
        return self.objects.setdefault(key, {}).setdefault(namespace, {})

    async def _notify(self, key: tuple, event_type: str, obj: dict) -> None:
        for q in self._watchers.get(key, []):
            await q.put({"type": event_type, "object": copy.deepcopy(obj)})

    def seed(self, group: str, version: str, resource: str, obj: dict) -> dict:
        """Synchronous test seeding (no watch events)."""
        key = (group, version, resource)
        t = self.types[key]
        meta = obj.setdefault("metadata", {})
        ns = meta.get("namespace", "") if t.namespaced else ""
        meta.setdefault("uid", str(uuid.uuid4()))
        meta.setdefault("resourceVersion", self._next_rv())
        meta.setdefault("creationTimestamp",
                        time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
        obj.setdefault("apiVersion", t.group_version)
        obj.setdefault("kind", t.kind)
        self._bucket(key, ns)[meta["name"]] = obj
        return obj

    # -- handler -------------------------------------------------------------

    async def __call__(self, req: Request) -> Response:
        resp = await self._handle(req)
        # gzip ownership test surface: encode when asked and body is large
        if (not resp.is_stream and resp.body
                and "gzip" in req.headers.get("Accept-Encoding", "")
                and len(resp.body) > 1024):
            resp.body = await self._gzip(resp.body)
            resp.headers.set("Content-Encoding", "gzip")
            resp.headers.set("Content-Length", str(len(resp.body)))
        return resp

    async def _gzip(self, body: bytes) -> bytes:
        """gzip of `body`, off the loop; a cached list body (the same
        bytes object until the next write) is compressed once, not on
        every request (a 10,000-pod list costs ~0.16 s to compress)."""
        key = (self._writes, id(body))
        hit = self._gzip_cache.get(key)
        if hit is not None and hit[0] is body:
            return hit[1]
        out = await asyncio.get_running_loop().run_in_executor(
            None, gzip_mod.compress, body)
        if len(body) > 65536:
            self._gzip_cache = {k: v for k, v in self._gzip_cache.items()
                                if k[0] == self._writes}
            self._gzip_cache[key] = (body, out)
        return out

    async def _handle(self, req: Request) -> Response:
        split = urlsplit(req.target)
        path = split.path
        query = parse_qs(split.query)

        if path in ("/healthz", "/readyz", "/livez"):
            return Response(status=200, body=b"ok")
        if path == "/api":
            return json_response(200, {"kind": "APIVersions", "versions": ["v1"],
                                       "serverAddressByClientCIDRs": []})
        if path == "/apis":
            groups: dict[str, dict] = {}
            for t in self.types.values():
                if not t.group:
                    continue
                g = groups.setdefault(t.group, {
                    "name": t.group,
                    "versions": [],
                    "preferredVersion": {"groupVersion": t.group_version,
                                         "version": t.version},
                })
                gv = {"groupVersion": t.group_version, "version": t.version}
                if gv not in g["versions"]:
                    g["versions"].append(gv)
            return json_response(200, {"kind": "APIGroupList",
                                       "apiVersion": "v1",
                                       "groups": list(groups.values())})
        if path == "/openapi/v2":
            return json_response(200, {"swagger": "2.0", "paths": {}})

        # resource-list discovery documents
        parts = [p for p in path.split("/") if p]
        if len(parts) == 2 and parts[0] == "api":
            return self._discovery_doc("", parts[1])
        if len(parts) == 3 and parts[0] == "apis":
            return self._discovery_doc(parts[1], parts[2])

        info = parse_request_info(req.method, req.target)
        if not info.is_resource_request or not info.resource:
            return json_response(404, _status(404, "NotFound", f"no handler for {path}"))

        key = (info.api_group, info.api_version, info.resource)
        t = self.types.get(key)
        if t is None:
            return json_response(404, _status(
                404, "NotFound",
                f"the server could not find the requested resource ({info.resource})"))

        ns = info.namespace if t.namespaced else ""
        if info.verb == "list":
            return await self._list(req, t, key, ns, query)
        if info.verb == "watch":
            return await self._watch(req, t, key, ns)
        if info.verb == "get":
            return await self._get(req, t, key, ns, info.name)
        if info.verb == "create":
            return await self._create(req, t, key, ns)
        if info.verb == "update":
            return await self._update(req, t, key, ns, info.name)
        if info.verb == "patch":
            return await self._patch(req, t, key, ns, info.name)
        if info.verb == "delete":
            return await self._delete(req, t, key, ns, info.name)
        if info.verb == "deletecollection":
            return await self._delete_collection(req, t, key, ns, query)
        return json_response(405, _status(405, "MethodNotAllowed",
                                          f"verb {info.verb} not supported"))

    def _discovery_doc(self, group: str, version: str) -> Response:
        resources = []
        for t in self.types.values():
            if t.group == group and t.version == version:
                resources.append({
                    "name": t.resource, "singularName": "",
                    "namespaced": t.namespaced, "kind": t.kind,
                    "verbs": ["create", "delete", "deletecollection", "get",
                              "list", "patch", "update", "watch"],
                })
        if not resources:
            return json_response(404, _status(404, "NotFound",
                                              f"no group/version {group}/{version}"))
        gv = f"{group}/{version}" if group else version
        return json_response(200, {"kind": "APIResourceList",
                                   "apiVersion": "v1",
                                   "groupVersion": gv,
                                   "resources": resources})

    # -- verbs ----------------------------------------------------------------

    def _all_in_scope(self, key: tuple, ns: str) -> list:
        by_ns = self.objects.get(key, {})
        if ns:
            return list(by_ns.get(ns, {}).values())
        out = []
        for bucket in by_ns.values():
            out.extend(bucket.values())
        return out

    @staticmethod
    def _wants_table(req: Request) -> bool:
        return "as=Table" in req.headers.get("Accept", "")

    @staticmethod
    def _wants_proto(req: Request) -> bool:
        return "application/vnd.kubernetes.protobuf" in \
            req.headers.get("Accept", "")

    @staticmethod
    def _proto_response(body: bytes) -> Response:
        resp = Response(status=200, body=body)
        resp.headers.set("Content-Type", "application/vnd.kubernetes.protobuf")
        resp.headers.set("Content-Length", str(len(body)))
        return resp

    def _to_table(self, t: ResourceType, items: list) -> dict:
        rows = []
        for obj in items:
            meta = obj.get("metadata", {})
            rows.append({
                "cells": [meta.get("name", ""), meta.get("creationTimestamp", "")],
                "object": {
                    "kind": "PartialObjectMetadata",
                    "apiVersion": "meta.k8s.io/v1",
                    "metadata": meta,
                },
            })
        return {
            "kind": "Table", "apiVersion": "meta.k8s.io/v1",
            "metadata": {"resourceVersion": str(self._rv)},
            "columnDefinitions": [
                {"name": "Name", "type": "string", "format": "name",
                 "description": "Name", "priority": 0},
                {"name": "Created At", "type": "date", "description": "ts",
                 "priority": 0},
            ],
            "rows": rows,
        }

    async def _list(self, req: Request, t: ResourceType, key: tuple, ns: str,
                    query: dict) -> Response:
        selector = (query.get("labelSelector") or [""])[0]
        # the body is encoded from the stored objects under the lock (the
        # reference deep-copies them first; the bytes are the same), off
        # the event loop, and once until the next write: a real apiserver
        # is another process, and in-process the encoding of a
        # 10,000-object list for each of many concurrent lists would hold
        # the interpreter lock against the proxy's own work on its loop
        # and in its batch threads
        form = (key, ns, selector, self._wants_table(req),
                self._wants_proto(req))
        async with self._lock:
            hit = self._list_cache.get(form)
            if hit is None or hit[0] != self._writes:
                resp = await asyncio.to_thread(self._list_response, req, t,
                                               key, ns, selector)
                hit = (self._writes, resp)
                self._list_cache[form] = hit
        resp = hit[1]
        return Response(status=resp.status,
                        headers=Headers(resp.headers.items()), body=resp.body)

    def _list_response(self, req: Request, t: ResourceType, key: tuple,
                       ns: str, selector: str) -> Response:
        items = [o for o in self._all_in_scope(key, ns)
                 if _match_label_selector(
                     selector, o.get("metadata", {}).get("labels") or {})]
        if self._wants_table(req):
            if self._wants_proto(req):
                # proto-negotiated Table: each row's object is a nested
                # `k8s\x00` envelope, like the real apiserver emits
                from ..proxy import k8sproto
                rows = [k8sproto.encode_unknown(
                    "meta.k8s.io/v1", "PartialObjectMetadata",
                    k8sproto.encode_object(
                        "meta.k8s.io/v1", "PartialObjectMetadata",
                        o.get("metadata", {}).get("name", ""),
                        o.get("metadata", {}).get("namespace", "")))
                    for o in items]
                return self._proto_response(k8sproto.encode_table(rows))
            return json_response(200, self._to_table(t, items))
        if self._wants_proto(req):
            # serve the k8s protobuf envelope (magic + runtime.Unknown);
            # items carry ObjectMeta only — enough for filtering, which
            # reads nothing else
            from ..proxy import k8sproto
            encoded = [k8sproto.encode_object(
                t.group_version, t.kind,
                o.get("metadata", {}).get("name", ""),
                o.get("metadata", {}).get("namespace", "")) for o in items]
            return self._proto_response(
                k8sproto.encode_list(t.group_version, t.list_kind, encoded))
        return json_response(200, {
            "kind": t.list_kind, "apiVersion": t.group_version,
            "metadata": {"resourceVersion": str(self._rv)},
            "items": items,
        })

    async def _watch(self, req: Request, t: ResourceType, key: tuple,
                     ns: str) -> Response:
        q: asyncio.Queue = asyncio.Queue()
        async with self._lock:
            self._watchers.setdefault(key, []).append(q)
            initial = [copy.deepcopy(o) for o in self._all_in_scope(key, ns)]

        wants_table = self._wants_table(req)
        wants_proto = self._wants_proto(req)

        async def stream():
            try:
                for obj in initial:
                    yield self._frame("ADDED", obj, t, wants_table,
                                      wants_proto)
                while True:
                    ev = await q.get()
                    obj = ev["object"]
                    if ns and obj.get("metadata", {}).get("namespace", "") != ns:
                        continue
                    yield self._frame(ev["type"], obj, t, wants_table,
                                      wants_proto)
            finally:
                watchers = self._watchers.get(key, [])
                if q in watchers:
                    watchers.remove(q)

        resp = Response(status=200, stream=stream())
        resp.headers.set(
            "Content-Type",
            "application/vnd.kubernetes.protobuf;stream=watch"
            if wants_proto else "application/json")
        return resp

    def _frame(self, event_type: str, obj: dict, t: ResourceType,
               wants_table: bool, wants_proto: bool = False) -> bytes:
        if wants_proto:
            # length-delimited raw WatchEvent, object re-enveloped — the
            # real apiserver's negotiated streaming serializer shape
            from ..proxy import k8sproto
            meta = obj.get("metadata", {})
            inner = k8sproto.encode_object(t.group_version, t.kind,
                                           meta.get("name", ""),
                                           meta.get("namespace", ""))
            if wants_table:
                # Table-mode watch: each event carries a one-row Table
                # whose row object is a nested PartialObjectMetadata
                # envelope — the same row shape the LIST Table path
                # serves (proxy unwraps via table_first_row_meta)
                env = k8sproto.encode_table([k8sproto.encode_unknown(
                    "meta.k8s.io/v1", "PartialObjectMetadata",
                    k8sproto.encode_object(
                        "meta.k8s.io/v1", "PartialObjectMetadata",
                        meta.get("name", ""), meta.get("namespace", "")),
                    "application/vnd.kubernetes.protobuf")])
            else:
                env = k8sproto.encode_unknown(
                    t.group_version, t.kind, inner,
                    "application/vnd.kubernetes.protobuf")
            return k8sproto.encode_watch_event(event_type, env)
        payload = self._to_table(t, [obj]) if wants_table else obj
        return (json.dumps({"type": event_type, "object": payload},
                           separators=(",", ":")) + "\n").encode()

    async def _get(self, req: Request, t: ResourceType, key: tuple, ns: str,
                   name: str) -> Response:
        async with self._lock:
            obj = self.objects.get(key, {}).get(ns, {}).get(name)
            if obj is None:
                return json_response(404, _status(
                    404, "NotFound", f'{t.resource} "{name}" not found',
                    {"name": name, "kind": t.resource}))
            obj = copy.deepcopy(obj)
        if self._wants_table(req):
            return json_response(200, self._to_table(t, [obj]))
        if self._wants_proto(req):
            from ..proxy import k8sproto
            meta = obj.get("metadata", {})
            raw = k8sproto.encode_object(t.group_version, t.kind,
                                         meta.get("name", ""),
                                         meta.get("namespace", ""))
            return self._proto_response(k8sproto.encode_unknown(
                t.group_version, t.kind, raw,
                "application/vnd.kubernetes.protobuf"))
        return json_response(200, obj)

    async def _create(self, req: Request, t: ResourceType, key: tuple,
                      ns: str) -> Response:
        try:
            obj = json.loads(req.body)
        except ValueError:
            return json_response(400, _status(400, "BadRequest", "invalid JSON body"))
        meta = obj.setdefault("metadata", {})
        name = meta.get("name", "")
        if not name and meta.get("generateName"):
            name = meta["generateName"] + uuid.uuid4().hex[:5]
            meta["name"] = name
        if not name:
            return json_response(422, _status(422, "Invalid", "metadata.name required"))
        if t.namespaced:
            meta["namespace"] = ns or meta.get("namespace", "default")
        async with self._lock:
            bucket = self._bucket(key, ns if t.namespaced else "")
            if name in bucket:
                return json_response(409, _status(
                    409, "AlreadyExists",
                    f'{t.resource} "{name}" already exists',
                    {"name": name, "kind": t.resource}))
            meta["uid"] = str(uuid.uuid4())
            meta["resourceVersion"] = self._next_rv()
            meta.setdefault("creationTimestamp",
                            time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
            obj.setdefault("apiVersion", t.group_version)
            obj.setdefault("kind", t.kind)
            bucket[name] = obj
            await self._notify(key, "ADDED", obj)
            return json_response(201, copy.deepcopy(obj))

    async def _update(self, req: Request, t: ResourceType, key: tuple,
                      ns: str, name: str) -> Response:
        try:
            obj = json.loads(req.body)
        except ValueError:
            return json_response(400, _status(400, "BadRequest", "invalid JSON body"))
        async with self._lock:
            bucket = self._bucket(key, ns)
            if name not in bucket:
                return json_response(404, _status(
                    404, "NotFound", f'{t.resource} "{name}" not found'))
            old = bucket[name]
            meta = obj.setdefault("metadata", {})
            meta["name"] = name
            meta["uid"] = old["metadata"]["uid"]
            meta["creationTimestamp"] = old["metadata"]["creationTimestamp"]
            if t.namespaced:
                meta["namespace"] = ns
            meta["resourceVersion"] = self._next_rv()
            obj.setdefault("apiVersion", t.group_version)
            obj.setdefault("kind", t.kind)
            bucket[name] = obj
            await self._notify(key, "MODIFIED", obj)
            return json_response(200, copy.deepcopy(obj))

    async def _patch(self, req: Request, t: ResourceType, key: tuple,
                     ns: str, name: str) -> Response:
        try:
            patch = json.loads(req.body)
        except ValueError:
            return json_response(400, _status(400, "BadRequest", "invalid JSON body"))
        async with self._lock:
            bucket = self._bucket(key, ns)
            if name not in bucket:
                return json_response(404, _status(
                    404, "NotFound", f'{t.resource} "{name}" not found'))
            obj = bucket[name]

            def merge(dst, src):
                for k, v in src.items():
                    if v is None:
                        dst.pop(k, None)
                    elif isinstance(v, dict) and isinstance(dst.get(k), dict):
                        merge(dst[k], v)
                    else:
                        dst[k] = copy.deepcopy(v)

            merge(obj, patch)
            obj["metadata"]["name"] = name
            obj["metadata"]["resourceVersion"] = self._next_rv()
            await self._notify(key, "MODIFIED", obj)
            return json_response(200, copy.deepcopy(obj))

    async def _delete(self, req: Request, t: ResourceType, key: tuple,
                      ns: str, name: str) -> Response:
        async with self._lock:
            bucket = self.objects.get(key, {}).get(ns, {})
            obj = bucket.pop(name, None)
            if obj is None:
                return json_response(404, _status(
                    404, "NotFound", f'{t.resource} "{name}" not found',
                    {"name": name, "kind": t.resource}))
            self._writes += 1
            await self._notify(key, "DELETED", obj)
            return json_response(200, _status(200, "", f'{t.resource} "{name}" deleted'))

    async def _delete_collection(self, req: Request, t: ResourceType,
                                 key: tuple, ns: str, query: dict) -> Response:
        selector = (query.get("labelSelector") or [""])[0]
        async with self._lock:
            victims = [o for o in self._all_in_scope(key, ns)
                       if _match_label_selector(
                           selector, o.get("metadata", {}).get("labels") or {})]
            self._writes += 1
            for obj in victims:
                ons = obj.get("metadata", {}).get("namespace", "") if t.namespaced else ""
                self.objects.get(key, {}).get(ons, {}).pop(
                    obj["metadata"]["name"], None)
                await self._notify(key, "DELETED", obj)
        return json_response(200, {
            "kind": t.list_kind, "apiVersion": t.group_version,
            "metadata": {}, "items": victims})
