"""Response filtering (reference pkg/authz/responsefilterer.go; this
package's reference authz/responsefilterer.py).

- StandardResponseFilterer: waits (≤10s) for the concurrently-running
  prefilter LookupResources, then filters list/object/Table response bodies
  against the allowed NamespacedName set.  Filter-denied single objects
  surface as 401 Unauthorized with a kube Status body; an empty filtered
  body becomes 404 (reference responsefilterer.go:716-735).
- WatchResponseFilterer: wraps the upstream watch stream; raw frames are
  replayed byte-exactly when allowed, buffered per NamespacedName until
  allowed, and dropped + unbuffered on revocation; Status events pass
  through (reference responsefilterer.go:423-714).
- EmptyResponseFilterer: pass-through for alwaysAllow requests.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from ..proxy.httpcore import Request, Response
from ..proxy.kube import RequestInfo
from ..proxy.restmapper import CachingRESTMapper, NoKindMatchError
from ..utils.admission import AdmissionRejectedError
from ..rules.engine import (
    ResolveInput,
    ResolvedPreFilter,
    RunnableRule,
    resolve_rel,
)
from ..spicedb.endpoints import PermissionsEndpoint
from ..utils.audit import (
    MAX_NAMES_PER_EVENT,
    NULL_SINK,
    OUTCOME_ALLOWED,
    OUTCOME_DENIED,
)
from ..utils.tracing import span
from .lookups import PrefilterResult, run_lookup_resources
from .rulesel import single_pre_filter_rule
from .watch import WATCH_FILTERED_TOTAL, WatchTracker, run_watch

PREFILTER_TIMEOUT = 10.0
# max not-yet-authorized frames buffered per watch (overflow drops oldest)
WATCH_BUFFER_CAP = 1024
# explained hidden objects per filtered list: one witness per hidden name
# up to this bound (a 10k-pod list must not trigger 10k oracle walks)
MAX_EXPLAINED_DENIALS = MAX_NAMES_PER_EVENT


class FilterError(Exception):
    pass


def _unauthorized_status(message: str) -> dict:
    return {
        "kind": "Status", "apiVersion": "v1", "metadata": {},
        "status": "Failure", "message": message, "reason": "Unauthorized",
        "code": 401,
    }


class _RecordingResult:
    """PrefilterResult wrapper recording each membership decision so the
    batched filter pass fans ONE audit event per object-group (allowed /
    denied), never one per object.  Bounded: counters plus a fixed-size
    name sample — a 10k-pod list must not allocate 10k tuples on the hot
    filter path just to feed an 8-name audit sample."""

    _SAMPLE = max(MAX_NAMES_PER_EVENT, MAX_EXPLAINED_DENIALS)

    def __init__(self, inner: PrefilterResult):
        self.inner = inner
        self.allowed_count = 0
        self.denied_count = 0
        self.allowed_names: list = []  # first _SAMPLE (namespace, name)
        self.denied_names: list = []

    @property
    def all_allowed(self) -> bool:
        return self.inner.all_allowed

    def is_allowed(self, namespace: str, name: str) -> bool:
        ok = self.inner.is_allowed(namespace, name)
        if ok:
            self.allowed_count += 1
            if len(self.allowed_names) < self._SAMPLE:
                self.allowed_names.append((namespace, name))
        else:
            self.denied_count += 1
            if len(self.denied_names) < self._SAMPLE:
                self.denied_names.append((namespace, name))
        return ok


class ResponseFilterer:
    async def filter_resp(self, resp: Response, req: Request) -> None:
        raise NotImplementedError


class EmptyResponseFilterer(ResponseFilterer):
    async def filter_resp(self, resp: Response, req: Request) -> None:
        return None


class StandardResponseFilterer(ResponseFilterer):
    def __init__(self, rest_mapper: CachingRESTMapper, input: ResolveInput,
                 filtered_rules: list, endpoint: Optional[PermissionsEndpoint]):
        self.rest_mapper = rest_mapper
        self.input = input
        self.filtered_rules = filtered_rules
        self.endpoint = endpoint
        self._prefilter_started = False
        self._prefilter_future: Optional[asyncio.Future] = None
        # strong ref: the loop holds tasks weakly; an unreferenced LR
        # task is collectable by the cyclic gc mid-flight (same latent
        # bug as the workflow engine's eager path)
        self._prefilter_task: Optional[asyncio.Task] = None
        self._resolved_prefilter: Optional[ResolvedPreFilter] = None
        self._prefilter_rule_name = ""

    def run_pre_filters(self) -> None:
        """Start the LR concurrently with the upstream request
        (reference responsefilterer.go:120-185)."""
        if self._prefilter_started:
            raise FilterError("pre-filters already started, cannot run again")
        self._prefilter_started = True

        rule = single_pre_filter_rule(self.filtered_rules)
        loop = asyncio.get_event_loop()
        self._prefilter_future = loop.create_future()
        if rule is None:
            self._prefilter_future.set_result(PrefilterResult(all_allowed=True))
            return
        if len(rule.pre_filter) != 1:
            raise FilterError(
                "pre-filter rule must have exactly one filter defined")
        f = rule.pre_filter[0]
        rel = resolve_rel(f.rel, self.input)
        resolved = ResolvedPreFilter(
            name_from_object_id=f.name_from_object_id,
            namespace_from_object_id=f.namespace_from_object_id,
            rel=rel,
        )
        self._resolved_prefilter = resolved
        self._prefilter_rule_name = rule.name

        async def runner():
            try:
                # the LR runs concurrently with the upstream request; the
                # task inherits the request's trace context, so the
                # kernel spans it triggers land in the request trace even
                # though respfilter only WAITS for it.  NOT a phase span:
                # it overlaps the `upstream` phase in wall time, and the
                # phase set must tile the request without double-counting
                with span("prefilter"):
                    result = await run_lookup_resources(self.endpoint,
                                                        resolved, self.input)
                if not self._prefilter_future.done():
                    self._prefilter_future.set_result(result)
            except Exception as e:
                if not self._prefilter_future.done():
                    self._prefilter_future.set_exception(e)

        self._prefilter_task = asyncio.ensure_future(runner())

    async def filter_resp(self, resp: Response, req: Request) -> None:
        if not self._prefilter_started:
            raise FilterError("pre-filters were not started, cannot filter response")
        try:
            # the wait is NOT the respfilter phase: its wall time is the
            # concurrent prefilter's (already attributed) — folding it in
            # would double-count kernel time against filtering
            with span("respfilter.wait"):
                result = await asyncio.wait_for(
                    asyncio.shield(self._prefilter_future), PREFILTER_TIMEOUT)
        except asyncio.TimeoutError:
            raise FilterError("timed out waiting for pre-filter") from None
        except FilterError:
            raise
        except AdmissionRejectedError:
            # admission rejection of the prefilter lookup is a 429 with
            # Retry-After, never a 502 bad-gateway wrap
            raise
        except Exception as e:
            raise FilterError(f"pre-filter error: {e}") from e

        from .middleware import AUDIT_KEY

        sink = req.context.get(AUDIT_KEY) or NULL_SINK
        if sink.enabled:
            # record membership decisions so the pass fans one audit
            # event per object-GROUP (allowed / denied), not per object
            result = _RecordingResult(result)
        with span("respfilter", phase=True):
            await self._apply_filters(resp, req, result)
        if isinstance(result, _RecordingResult):
            await self._audit_groups(req, sink, result)

    async def _audit_groups(self, req: Request, sink,
                            rec: "_RecordingResult") -> None:
        """One event per decision group; explained denials attach a
        relation-path witness per hidden object (bounded)."""
        from .middleware import audit_event_for, explain_requested

        rule = self._prefilter_rule_name
        if not rule:
            # no prefilter rule (all_allowed pass-through): keep the
            # request's matched rules from the context
            rule = ",".join(req.context.get("matched_rules") or ())
        # the frontier's evaluator (cache|kernel|oracle) outranks the
        # check-phase source for filtered-list events: the GROUP decision
        # is the prefilter's
        source = getattr(rec.inner, "source", "")
        if rec.allowed_count:
            sink.emit(audit_event_for(
                req, "respfilter", OUTCOME_ALLOWED, rule=rule,
                names=tuple(f"{ns}/{n}" if ns else n
                            for ns, n in
                            rec.allowed_names[:MAX_NAMES_PER_EVENT]),
                count=rec.allowed_count,
                **({"decision_source": source} if source else {})))
        if not rec.denied_count:
            return
        explain = None
        rel = (self._resolved_prefilter.rel
               if self._resolved_prefilter is not None else None)
        if rel is not None and explain_requested(req):
            from .explain import witness_dict_for_rel

            explain = {}
            for ns, n in rec.denied_names[:MAX_EXPLAINED_DENIALS]:
                oid = self._explain_oid(rel, ns, n)
                w = await witness_dict_for_rel(self.endpoint, rel,
                                               object_id=oid)
                if w is not None:
                    explain[oid] = w
        sink.emit(audit_event_for(
            req, "respfilter", OUTCOME_DENIED, rule=rule,
            rel=rel.rel_string() if rel is not None else "",
            names=tuple(f"{ns}/{n}" if ns else n
                        for ns, n in
                        rec.denied_names[:MAX_NAMES_PER_EVENT]),
            count=rec.denied_count,
            explain=explain,
            **({"decision_source": source} if source else {})))

    def _explain_oid(self, rel, namespace: str, name: str) -> str:
        """Best-effort inverse of the rule's fromObjectID expressions:
        the proxy's dominant id convention is namespacedName ("ns/name",
        bare name cluster-scoped).  Rules whose namespace comes from the
        REQUEST (lookups.py namespace fallback) key objects by bare
        name — detected by asking the endpoint's store which id it
        actually knows, so the witness never probes a fabricated id."""
        primary = f"{namespace}/{name}" if namespace else name
        if namespace:
            store = getattr(self.endpoint, "store", None)
            if store is not None:
                try:
                    ids = store.object_ids_of_type(rel.resource_type)
                    if primary not in ids and name in ids:
                        return name
                except Exception:
                    pass
        return primary

    async def _apply_filters(self, resp: Response, req: Request,
                             result: PrefilterResult) -> None:
        info: RequestInfo = req.context["request_info"]
        # error responses pass through unfiltered (responsefilterer.go:229-234)
        if 400 <= resp.status <= 599:
            return

        from ..proxy import k8sproto

        # a Table request short-circuits GVK handling
        if "as=Table" in req.headers.get("Accept", ""):
            if k8sproto.is_k8s_proto(resp.body):
                try:
                    body = self._filter_table_proto(resp.body, result)
                except k8sproto.K8sProtoError as e:
                    raise FilterError(
                        f"error decoding protobuf table: {e}") from e
                self._write_resp(resp, body, None)
                return
            try:
                body, err = self._filter_table(resp.body, result)
            except ValueError as e:
                raise FilterError(f"error decoding table: {e}") from e
            self._write_resp(resp, body, err)
            return

        content_type = resp.headers.get("Content-Type", "application/json")
        media = content_type.split(";")[0].strip()
        if "json" not in media:
            if k8sproto.is_k8s_proto(resp.body):
                # negotiated protobuf body: filter at the wire level
                # (reference responsefilterer.go:241-301; unparseable
                # bodies reject like unrecognized-GVK proto at 278-280)
                await self._filter_proto(resp, info, result)
                return
            gvk = await self._gvk(info)
            raise FilterError(
                f"unsupported media type {media} for gvk {gvk}")

        try:
            decoded = json.loads(resp.body) if resp.body else {}
        except ValueError as e:
            raise FilterError(f"failed to decode response body: {e}") from e

        if len(info.parts) == 1:
            # list response
            err = self._filter_list(decoded, result)
            body = b"" if err else json.dumps(decoded).encode()
            self._write_resp(resp, body, err)
        else:
            err = self._filter_object(decoded, result)
            self._write_resp(resp, resp.body if not err else b"", err)

    async def _gvk(self, info: RequestInfo):
        try:
            return await self.rest_mapper.kind_for(
                info.api_group, info.api_version, info.resource)
        except NoKindMatchError as e:
            raise FilterError(str(e)) from e

    async def _filter_proto(self, resp: Response, info: RequestInfo,
                            result: PrefilterResult) -> None:
        """Filter a `k8s\\x00`-enveloped protobuf list/object body by
        wire-level splicing (proxy/k8sproto.py)."""
        from ..proxy import k8sproto

        try:
            api_version, kind, raw, ct = k8sproto.decode_unknown(resp.body)
            if len(info.parts) == 1 and kind.endswith("List"):
                filtered = k8sproto.filter_list_raw(raw, result.is_allowed)
                body = k8sproto.encode_unknown(api_version, kind, filtered, ct)
                self._write_resp(resp, body, None)
            else:
                namespace, name = k8sproto.object_meta(raw)
                if result.is_allowed(namespace, name):
                    self._write_resp(resp, resp.body, None)
                else:
                    self._write_resp(resp, b"", FilterError("unauthorized"))
        except k8sproto.K8sProtoError as e:
            raise FilterError(
                f"unable to filter protobuf body for gvk "
                f"{await self._gvk(info)}: {e}") from e

    def _filter_table_proto(self, body: bytes, result: PrefilterResult) -> bytes:
        from ..proxy import k8sproto

        api_version, kind, raw, ct = k8sproto.decode_unknown(body)
        filtered = k8sproto.filter_table_raw(raw, result.is_allowed)
        return k8sproto.encode_unknown(api_version, kind, filtered, ct)

    def _filter_table(self, body: bytes, result: PrefilterResult) -> tuple:
        table = json.loads(body)
        rows = table.get("rows") or []
        allowed_rows = []
        for r in rows:
            pom = (r.get("object") or {}).get("metadata") or {}
            if result.is_allowed(pom.get("namespace", "") or "",
                                 pom.get("name", "") or ""):
                allowed_rows.append(r)
        table["rows"] = allowed_rows
        return json.dumps(table).encode(), None

    def _filter_list(self, decoded: dict, result: PrefilterResult):
        items = decoded.get("items")
        if not isinstance(items, list):
            return None
        allowed = []
        for item in items:
            meta = (item.get("metadata") or {}) if isinstance(item, dict) else {}
            if result.is_allowed(meta.get("namespace", "") or "",
                                 meta.get("name", "") or ""):
                allowed.append(item)
        decoded["items"] = allowed
        return None

    def _filter_object(self, decoded: dict, result: PrefilterResult):
        meta = decoded.get("metadata") or {}
        if result.is_allowed(meta.get("namespace", "") or "",
                             meta.get("name", "") or ""):
            return None
        return FilterError("unauthorized")

    @staticmethod
    def _write_resp(resp: Response, body: bytes, err) -> None:
        """401-on-error / 404-on-empty (reference responsefilterer.go:716-735)."""
        if err is not None:
            body = json.dumps(_unauthorized_status(str(err))).encode()
            resp.status = 401
        resp.body = body
        resp.headers.set("Content-Length", str(len(body)))
        if len(body) == 0:
            resp.status = 404


class WatchResponseFilterer(ResponseFilterer):
    # class-level defaults so partially-constructed instances (tests
    # drive _filtered_stream directly) still count and audit safely
    input: Optional[ResolveInput] = None
    watch_rule: Optional[RunnableRule] = None
    audit = NULL_SINK

    def __init__(self, rest_mapper: CachingRESTMapper, input: ResolveInput,
                 watch_rule: RunnableRule, endpoint: PermissionsEndpoint,
                 audit=NULL_SINK):
        self.rest_mapper = rest_mapper
        self.input = input
        self.watch_rule = watch_rule
        self.endpoint = endpoint
        self.audit = audit
        self._tracker: Optional[WatchTracker] = None
        self._watch_task: Optional[asyncio.Task] = None

    @property
    def _resource(self) -> str:
        """Bounded metric label: the kube resource this watch serves."""
        info = self.input.request if self.input is not None else None
        return (info.resource if info is not None else "") or "unknown"

    def _count_filtered(self) -> None:
        WATCH_FILTERED_TOTAL.inc(resource=self._resource)

    def _audit_watch(self, decision: str, namespace: str, name: str,
                     message: str = "") -> None:
        """Mid-stream decision event (no live Request context: watch
        frames outlive the request that opened the stream)."""
        if not self.audit.enabled:
            return
        from ..utils.audit import AuditEvent
        from ..utils import tracing

        user = self.input.user if self.input is not None else None
        info = (self.input.request if self.input is not None
                else None) or RequestInfo()
        tr = tracing.current_trace()
        self.audit.emit(AuditEvent(
            stage="watch", decision=decision,
            user=user.name if user else "",
            groups=tuple(user.groups) if user else (),
            verb="watch", api_group=info.api_group,
            api_version=info.api_version, resource=info.resource,
            namespace=namespace, names=(name,) if name else (), count=1,
            rule=self.watch_rule.name if self.watch_rule else "",
            backend=getattr(self.audit, "backend", ""),
            trace_id=getattr(tr, "trace_id", ""),
            message=message))

    def run_watcher(self) -> None:
        """Start the SpiceDB-side watch (reference responsefilterer.go:434-460)."""
        if self._tracker is not None:
            raise FilterError("watcher already started, cannot run again")
        if len(self.watch_rule.pre_filter) != 1:
            raise FilterError("watch rule must have exactly one pre-filter defined")
        f = self.watch_rule.pre_filter[0]
        rel = resolve_rel(f.rel, self.input)
        resolved = ResolvedPreFilter(
            name_from_object_id=f.name_from_object_id,
            namespace_from_object_id=f.namespace_from_object_id,
            rel=rel,
        )
        self._tracker = WatchTracker()
        # subscribe synchronously: tuple writes racing the watch setup must
        # not be lost before the watch task first runs
        watcher = self.endpoint.watch([resolved.rel.resource_type])
        self._watch_task = asyncio.ensure_future(
            run_watch(self.endpoint, self._tracker, resolved, self.input,
                      watcher=watcher))

    async def filter_resp(self, resp: Response, req: Request) -> None:
        if self._tracker is None:
            raise FilterError("watcher was not started, cannot filter response")
        if resp.stream is None:
            return  # error responses pass through
        with span("respfilter", phase=True):
            self._wrap_stream(resp)

    def _wrap_stream(self, resp: Response) -> None:
        upstream = resp.stream
        # the upstream Content-Type decides the stream framing/codec, the
        # analog of the reference's negotiated streaming serializer
        # (responsefilterer.go:500-506)
        content_type = resp.headers.get("Content-Type", "")
        proto = "protobuf" in content_type
        resp.stream = self._filtered_stream(upstream, proto=proto)

    @staticmethod
    def _decode_frame(raw: bytes, proto: bool) -> tuple:
        """(event_type, namespace, name, is_status) for one raw frame.
        Raises ValueError when the frame cannot be decoded — the caller
        must DROP such frames (fail closed), never relay them."""
        if proto:
            from ..proxy import k8sproto

            try:
                ev, api_version, kind, obj_raw = k8sproto.decode_watch_event(
                    raw[4:])
                if ev == "ERROR" or kind == "Status":
                    return ev, "", "", True
                # Table event unwrapping (responsefilterer.go:667-677)
                if kind == "Table" and "meta.k8s.io" in api_version:
                    namespace, name = k8sproto.table_first_row_meta(obj_raw)
                else:
                    namespace, name = k8sproto.object_meta(obj_raw)
            except k8sproto.K8sProtoError as e:
                raise ValueError(str(e)) from e
            return ev, namespace, name, False
        event = json.loads(raw)  # ValueError propagates to the caller
        if not isinstance(event, dict):
            raise ValueError("watch frame is not a JSON object")
        obj = event.get("object") or {}
        ev = event.get("type", "")
        if ev == "ERROR" or obj.get("kind") == "Status":
            return ev, "", "", True
        meta = obj.get("metadata") or {}
        name = meta.get("name", "")
        namespace = meta.get("namespace", "")
        # Table event unwrapping (responsefilterer.go:667-677)
        if (obj.get("kind") == "Table"
                and "meta.k8s.io" in obj.get("apiVersion", "")):
            for r in obj.get("rows") or []:
                rmeta = (r.get("object") or {}).get("metadata") or {}
                name = rmeta.get("name", "")
                namespace = rmeta.get("namespace", "")
                break
        return ev, namespace, name, False

    async def _filtered_stream(self, upstream, proto: bool = False):
        """Replay / buffer / revoke raw frames
        (reference responsefilterer.go:487-714)."""
        from .frames import frame_length_delimited, frame_lines

        framer = frame_length_delimited if proto else frame_lines
        merged: asyncio.Queue = asyncio.Queue()

        async def pump_upstream():
            try:
                async for raw in framer(upstream):
                    await merged.put(("frame", raw))
            finally:
                await merged.put(("eof", None))

        async def pump_changes():
            while True:
                change = await self._tracker.changes.get()
                await merged.put(("change", change))

        pump1 = asyncio.ensure_future(pump_upstream())
        pump2 = asyncio.ensure_future(pump_changes())
        allowed: set = set()
        # bounded not-yet-authorized frame buffer: a watch on a resource
        # the subject will never be granted must not grow memory without
        # limit — overflow drops the OLDEST buffered frame (the client
        # re-lists on resume, matching kube watch semantics)
        buffered: dict = {}
        try:
            while True:
                kind, payload = await merged.get()
                if kind == "eof":
                    return
                if kind == "change":
                    nn = (payload.namespace, payload.name)
                    if payload.allowed:
                        if nn not in allowed:
                            # grant events are audited symmetrically
                            # with revocations (per-frame deliveries are
                            # not — one decision, not one per frame)
                            self._audit_watch(OUTCOME_ALLOWED, *nn,
                                              message="granted")
                        allowed.add(nn)
                        if nn in buffered:
                            raw = buffered.pop(nn)
                            yield raw
                    else:
                        was_visible = nn in allowed or nn in buffered
                        if nn in buffered:
                            # a buffered frame the client will never see
                            self._count_filtered()
                        allowed.discard(nn)
                        buffered.pop(nn, None)
                        if was_visible:
                            self._audit_watch(OUTCOME_DENIED, *nn,
                                              message="revoked")
                    continue
                raw = payload
                try:
                    ev, namespace, name, is_status = self._decode_frame(
                        raw, proto)
                except ValueError as e:
                    # FAIL CLOSED: an undecodable frame may carry an object
                    # we cannot authorize — drop it with an error, never
                    # relay it (this path previously passed frames through
                    # unfiltered, an authorization bypass)
                    import logging
                    logging.getLogger(__name__).error(
                        "dropping undecodable watch frame (%d bytes, "
                        "proto=%s): %s", len(raw), proto, e)
                    self._count_filtered()
                    continue
                if is_status:
                    # status events pass through and the stream CONTINUES
                    # (reference responsefilterer.go:645-651 writes the
                    # chunk and keeps reading)
                    yield raw
                    continue
                if ev in ("ADDED", "MODIFIED"):
                    nn = (namespace or "", name)
                    if nn in allowed:
                        yield raw
                    else:
                        # buffered, NOT yet counted as filtered: a later
                        # grant may still deliver it — only definitive
                        # drops (revocation/overflow/undecodable) count
                        buffered[nn] = raw
                        if len(buffered) > WATCH_BUFFER_CAP:
                            victim = next(iter(buffered))
                            buffered.pop(victim)
                            self._count_filtered()
                            import logging
                            logging.getLogger(__name__).warning(
                                "watch buffer cap %d exceeded; dropped "
                                "buffered frame for %s", WATCH_BUFFER_CAP,
                                victim)
                # DELETED / BOOKMARK events: the reference neither replays nor
                # buffers them (only ADDED/MODIFIED are handled)
        finally:
            pump1.cancel()
            pump2.cancel()
            if self._watch_task is not None:
                self._watch_task.cancel()
