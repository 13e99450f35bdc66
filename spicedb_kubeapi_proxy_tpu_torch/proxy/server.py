"""Proxy server: handler-chain assembly and the reverse proxy
(reference pkg/proxy/server.go; this package's reference proxy/server.py,
trimmed to the read path).

Chain (bottom-up, reference server.go:153-160):
  PanicRecovery -> HTTPLogging -> RequestInfo -> Authentication ->
  Authorization -> ReverseProxy(upstream, ModifyResponse=FilterResp)

plus /readyz and /livez health endpoints, the authenticated /metrics
scrape, and the embedded in-process client with header-injecting
transport (reference server.go:282-403 and pkg/inmemory).

`ProxyServer(Options(spicedb_endpoint="torch://"))` serves on the CUDA
card through the batched `torch://` endpoint; `torch://?device=cpu` runs
the kernels' plain twins on the CPU.  Left out against the reference,
each with its `Options` fields (passing one is a TypeError): dual writes
(`enable_dual_writes`, `workflow_database_path`, `lock_mode_default`; an
update rule answers 500 "update engine not configured"), the durable
store (`data_dir`, `wal_fsync`, `checkpoint_interval`), replication and
sharding (`replicate_from` ... `replica_id`, `shards`,
`partition_map`), fleet tracing (`fleet_peers`), device telemetry and
the flight recorder (`flight_*`, `slo_*`, `device_hbm_peak_gbps`,
`shed_slo_burn`) and the /debug surfaces.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
import ssl
import time
from dataclasses import dataclass, field
from typing import Optional

from ..authz.middleware import (
    FILTERER_KEY,
    forbidden_response,
    with_authorization,
)
from ..authz.responsefilterer import FilterError
from ..config import proxyrule
from ..rules.engine import MapMatcher
from ..spicedb.endpoints import Bootstrap, PermissionsEndpoint, create_endpoint
from ..utils import tracing
from ..utils.admission import AdmissionRejectedError, LoadShedder
from ..utils.audit import (
    AuditSink,
    LEVEL_METADATA,
    OUTCOME_SHED,
    normalize_outcome,
)
from .authn import (
    Authenticator,
    AuthenticatorChain,
    ClientCertAuthenticator,
    HeaderAuthenticator,
    REMOTE_EXTRA_PREFIX,
    REMOTE_GROUP_HEADER,
    REMOTE_USER_HEADER,
)
from .httpcore import (
    Handler,
    HandlerTransport,
    Headers,
    HttpServer,
    Request,
    Response,
    Transport,
    json_response,
)
from .kube import parse_request_info
from .restmapper import CachingRESTMapper

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.proxy")

_KV_TRUNCATE = 200  # keep object/body values from flooding the log line

# health endpoints and the metrics scrape are not themselves traced
_UNTRACED_PATHS = frozenset(("/metrics", "/readyz", "/livez", "/healthz"))


def too_many_requests_response(retry_after_s: float, message: str) -> Response:
    """Kube-style 429 Status with a Retry-After header (admission
    control)."""
    resp = json_response(429, {
        "kind": "Status", "apiVersion": "v1", "metadata": {},
        "status": "Failure", "message": message,
        "reason": "TooManyRequests", "code": 429,
        "details": {"retryAfterSeconds": max(1, int(round(retry_after_s)))},
    })
    resp.headers.set("Retry-After",
                     str(max(1, int(round(retry_after_s)))))
    return resp


def format_request_kv(req) -> str:
    """Structured key-values for the request log line (reference
    pkg/authz/requestlogger.go + rules.go:242-279 ToKeyValues): user,
    groups, verb/GVR, name/namespace, matched rules, authz outcome."""
    parts = []
    user = req.context.get("user")
    if user is not None:
        parts += [("user", user.name), ("groups", ",".join(user.groups))]
    inp = req.context.get("resolve_input")
    if inp is not None:
        kv = inp.to_key_values()
        for k, v in zip(kv[::2], kv[1::2]):
            lk = k.lower()
            # never log payloads: `body`/`object` can carry Secret data;
            # credential-bearing headers are redacted
            if lk in ("body", "object"):
                continue
            if lk in ("authorization", "cookie", "proxy-authorization"):
                v = "[redacted]"
            s = str(v)
            if len(s) > _KV_TRUNCATE:
                s = s[:_KV_TRUNCATE] + "…"
            parts.append((k, s))
    rules = req.context.get("matched_rules")
    if rules is not None:
        parts.append(("rules", ",".join(rules)))
    outcome = req.context.get("authz_outcome")
    if outcome is not None:
        parts.append(("authz", normalize_outcome(outcome)))
    if not parts:
        return ""
    return " " + " ".join(f"{k}={v!r}" for k, v in parts)


@dataclass
class Options:
    """Server configuration (reference pkg/proxy/options.go; the read
    path's fields of this package's reference Options)."""
    spicedb_endpoint: str = "embedded://"
    bootstrap: Optional[Bootstrap] = None
    rules_yaml: str = ""
    rule_configs: list = field(default_factory=list)
    upstream_transport: Optional[Transport] = None  # kube-apiserver seam
    authenticators: Optional[list] = None
    ssl_context: Optional[ssl.SSLContext] = None
    endpoint_kwargs: dict = field(default_factory=dict)
    # endpoint-boundary check/LR latency + batch-size metrics
    enable_metrics: bool = True
    # requests slower than this (seconds) emit their full trace as a
    # structured JSON log line; 0 disables the log
    trace_slow_threshold: float = 0.0
    # decision audit (utils/audit.py): level policy (None/Metadata/Request),
    # 1-in-N per-user+verb sampling of ALLOWED decisions (denials always
    # pass), and explain mode (every audited denial carries the
    # relation-path witness; off, `?explain=1` still explains per request)
    audit_level: str = LEVEL_METADATA
    audit_sample_every: int = 1
    audit_explain: bool = False
    # warm start before serving (`warm_start`): build the device graph,
    # the kernel library and every lane bucket's sweep graphs, so the
    # first request of each bucket pays none of it; off-loop rebuild
    # candidates are prewarmed the same way
    prewarm_compiles: bool = False
    # admission control (utils/admission.py): shed_queue_depth > 0
    # rejects read-only requests with 429 + Retry-After BEFORE
    # authorization work starts once the dispatcher queues (check + LR)
    # reach that depth.  The dispatcher's own queue bound is the
    # endpoint's max_queue_depth (a URL parameter or endpoint kwarg).
    shed_queue_depth: int = 0
    shed_retry_after_s: float = 1.0


class ProxyServer:
    """The assembled proxy (reference pkg/proxy/server.go:41-164)."""

    def __init__(self, opts: Options):
        if opts.upstream_transport is None:
            raise ValueError("upstream_transport (kube-apiserver seam) is required")
        self.opts = opts
        configs = list(opts.rule_configs)
        if opts.rules_yaml:
            configs.extend(proxyrule.parse(opts.rules_yaml))
        self.endpoint: PermissionsEndpoint = create_endpoint(
            opts.spicedb_endpoint, bootstrap=opts.bootstrap,
            **opts.endpoint_kwargs)
        # metric and audit label: the URL scheme
        backend = opts.spicedb_endpoint.split(":")[0]
        if opts.enable_metrics:
            from ..spicedb.instrumented import InstrumentedEndpoint
            self.endpoint = InstrumentedEndpoint(
                self.endpoint, backend_label=backend)
        self.audit = AuditSink(level=opts.audit_level,
                               sample_every=opts.audit_sample_every,
                               explain=opts.audit_explain,
                               backend=backend)
        # exposed mutable matcher (reference server.go:145-146: e2e tests
        # swap rule sets at runtime through the *Matcher pointer)
        self.matcher = MapMatcher(configs)
        self.rest_mapper = CachingRESTMapper(opts.upstream_transport)
        self.authenticator: Authenticator = AuthenticatorChain(
            opts.authenticators if opts.authenticators is not None
            else [HeaderAuthenticator(), ClientCertAuthenticator()])
        self.handler = self._build_chain()
        # load shedder: reads shed at the door when the dispatcher queues
        # are already deep.  The queue-depth accessor is found through the
        # wrapper layers once, here: the door check runs per read request
        depth_fn = None
        ep = self.endpoint
        while ep is not None:
            fn = getattr(ep, "queue_depth", None)
            if callable(fn):
                depth_fn = fn
                break
            ep = getattr(ep, "inner", None)
        if opts.shed_queue_depth > 0 and depth_fn is None:
            # e.g. `torch://?dispatch=direct`: no dispatcher queues to
            # measure, so the threshold can never fire — say so
            logger.warning(
                "shed_queue_depth %d is configured but the endpoint "
                "exposes no dispatcher queue depth (dispatch=direct?) — "
                "queue-depth shedding will never trigger",
                opts.shed_queue_depth)
        self.shedder = LoadShedder(
            shed_queue_depth=opts.shed_queue_depth,
            retry_after_s=opts.shed_retry_after_s,
            depth_fn=depth_fn)
        # off-loop rebuilds prewarm their candidate generations when
        # compile prewarm is on, so a post-swap first request captures
        # nothing.  The flag is set on the endpoint that owns it: the
        # wrappers forward reads but would keep a write for themselves
        if opts.prewarm_compiles:
            inner = self.endpoint
            while inner is not None and "prewarm_rebuilds" not in vars(inner):
                inner = getattr(inner, "inner", None)
            if inner is not None:
                inner.prewarm_rebuilds = True
        self._http: Optional[HttpServer] = None
        self._lag_probe = None

    # -- chain ---------------------------------------------------------------

    def _build_chain(self) -> Handler:
        cluster_proxy = self._make_cluster_proxy()

        async def failed(req: Request) -> Response:
            return forbidden_response("forbidden: not permitted by proxy rules")

        authorized = with_authorization(
            cluster_proxy, failed, self.rest_mapper, self.endpoint,
            matcher_ref=lambda: self.matcher,
            audit=self.audit)

        async def authenticated(req: Request) -> Response:
            user = self.authenticator.authenticate(req)
            if user is None:
                return json_response(401, {
                    "kind": "Status", "apiVersion": "v1", "metadata": {},
                    "status": "Failure", "message": "Unauthorized",
                    "reason": "Unauthorized", "code": 401})
            req.context["user"] = user
            # /metrics is authenticated-only: any valid principal may scrape
            # (weaker than kube-apiserver, which additionally authorizes the
            # path via RBAC nonResourceURLs); health endpoints stay open
            if req.path == "/metrics" and self.opts.enable_metrics:
                from ..utils.metrics import REGISTRY
                resp = Response(status=200, body=REGISTRY.render().encode())
                resp.headers.set("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                return resp
            # admission control: shed read-only traffic at the door when
            # the proxy is already saturated, and convert dispatcher
            # queue-bound rejections raised anywhere in the authorization
            # pipeline into 429s.  Update verbs are never shed.
            info = req.context.get("request_info")
            verb = info.verb if info is not None else req.method.lower()
            reason = self.shedder.check(verb)
            if reason is not None:
                req.context["authz_outcome"] = OUTCOME_SHED
                return too_many_requests_response(
                    self.shedder.retry_after_s,
                    f"request shed by admission control ({reason}); "
                    f"retry after {self.shedder.retry_after_s:.0f}s")
            try:
                return await authorized(req)
            except AdmissionRejectedError as e:
                req.context["authz_outcome"] = OUTCOME_SHED
                return too_many_requests_response(e.retry_after_s, str(e))

        async def with_request_info(req: Request) -> Response:
            if req.path in ("/readyz", "/livez", "/healthz"):
                body = b"ok"
                if req.path == "/readyz" and self.shedder.shedding_recently():
                    # shedding is degraded-but-200: the proxy is
                    # protecting itself, and ejecting the pod would turn
                    # deliberate backpressure into a real outage
                    body = (b"ok\n[!] admission control shedding "
                            b"read-only traffic (429)")
                return Response(status=200, body=body)
            req.context["request_info"] = parse_request_info(req.method,
                                                             req.target)
            return await authenticated(req)

        if self.opts.enable_metrics:
            from ..utils.metrics import REGISTRY
            request_counter = REGISTRY.counter(
                "proxy_http_requests_total",
                "Proxied HTTP requests by verb and status code",
                labels=("verb", "code"))
            request_latency = REGISTRY.histogram(
                "proxy_http_request_seconds",
                "Proxied HTTP request latency by verb",
                labels=("verb",))
            phase_latency = REGISTRY.histogram(
                "authz_request_phase_seconds",
                "Request latency attributed to tracing phases (authn, "
                "resolve, match, upstream, respfilter, ...)",
                labels=("phase",))
        else:
            request_counter = request_latency = phase_latency = None

        slow_threshold = self.opts.trace_slow_threshold

        async def with_logging(req: Request) -> Response:
            tr = token = None
            if req.path not in _UNTRACED_PATHS:
                # trace-id assignment: honor a well-formed caller id so
                # multi-hop traces correlate; anything else gets a fresh id
                tr, token = tracing.start_trace(
                    trace_id=tracing.clean_trace_id(
                        req.headers.get(tracing.TRACE_ID_HEADER)),
                    method=req.method, target=req.target)
            start = time.monotonic()
            try:
                resp = await with_request_info(req)
            finally:
                if tr is not None:
                    tracing.end_trace(token)
                    tr.finish()
            elapsed = time.monotonic() - start
            info = req.context.get("request_info")
            verb = info.verb if info else req.method.lower()
            # one outcome vocabulary across log kv, trace attrs, and
            # audit events (utils/audit.py OUTCOME_*)
            raw_outcome = req.context.get("authz_outcome")
            outcome = (normalize_outcome(raw_outcome)
                       if raw_outcome is not None else None)
            if raw_outcome is not None:
                req.context["authz_outcome"] = outcome
            if tr is not None:
                user = req.context.get("user")
                tr.attrs.update(verb=verb, status=resp.status,
                                **({"user": user.name} if user else {}),
                                **({"outcome": outcome} if outcome else {}))
                resp.headers.set(tracing.TRACE_ID_HEADER, tr.trace_id)
                if phase_latency is not None:
                    for phase, secs in tr.phase_durations().items():
                        phase_latency.observe(secs, phase=phase)
                tracing.RECORDER.record(tr)
                if slow_threshold and tr.duration >= slow_threshold:
                    logger.warning("slow request trace: %s",
                                   json.dumps(tr.to_dict(), sort_keys=True))
            if logger.isEnabledFor(logging.INFO):
                logger.info("%s %s -> %d (%.1fms)%s", req.method,
                            req.target, resp.status, elapsed * 1e3,
                            format_request_kv(req))
            if request_counter is not None:
                request_counter.inc(verb=verb, code=resp.status)
                request_latency.observe(elapsed, verb=verb)
            return resp

        async def with_panic_recovery(req: Request) -> Response:
            try:
                return await with_logging(req)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.exception("panic serving %s %s", req.method, req.target)
                return json_response(500, {
                    "kind": "Status", "apiVersion": "v1", "metadata": {},
                    "status": "Failure", "message": f"internal error: {e}",
                    "code": 500})

        return with_panic_recovery

    def _make_cluster_proxy(self) -> Handler:
        upstream = self.opts.upstream_transport

        async def cluster_proxy(req: Request) -> Response:
            up_headers = Headers()
            for k, v in req.headers.items():
                lk = k.lower()
                # the proxy owns encoding (reference server.go:98-108) and
                # identity headers must not leak upstream
                if lk in ("accept-encoding", "authorization", "connection",
                          "content-length", "host"):
                    continue
                if lk.startswith("x-remote-"):
                    continue
                up_headers.add(k, v)
            up_req = Request(method=req.method, target=req.target,
                             headers=up_headers, body=req.body)
            with tracing.span("upstream", phase=True):
                resp = await upstream.round_trip(up_req)

            filterer = req.context.get(FILTERER_KEY)
            if filterer is not None:
                try:
                    await filterer.filter_resp(resp, req)
                except FilterError as e:
                    # ModifyResponse errors surface as 502 (server.go:119-124)
                    return json_response(502, {
                        "kind": "Status", "apiVersion": "v1", "metadata": {},
                        "status": "Failure",
                        "message": f"bad gateway: {e}", "code": 502})
            return resp

        return cluster_proxy

    # -- serving -------------------------------------------------------------

    async def warm_start(self) -> None:
        """Build the device graph before serving, and with
        `prewarm_compiles` also the kernel library and every lane
        bucket's sweep graphs, off the event loop (`TorchEndpoint.
        warm_start`).  `start()` runs it; a caller serving through the
        embedded client runs it itself.  A no-op for an endpoint with no
        device graph."""
        warm = getattr(self.endpoint, "warm_start", None)
        if warm is None:
            return
        prewarm = self.opts.prewarm_compiles
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()
        with tracing.request_trace(op="warm_start") as tr:
            with tracing.span("warm_start", phase=True):
                await loop.run_in_executor(
                    None, lambda: ctx.run(warm, prewarm=prewarm))
        tracing.RECORDER.record(tr)

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        if self.opts.prewarm_compiles:
            await self.warm_start()
        self._http = HttpServer(self.handler, ssl_context=self.opts.ssl_context)
        bound = await self._http.start(host, port)
        # audit writer + runtime self-metrics ride the serving lifecycle;
        # embedded (handler-only) use still audits through the ring
        # buffer — only the JSON-line writer needs the loop task
        await self.audit.start()
        if self.opts.enable_metrics:
            from ..utils.metrics import EventLoopLagProbe, \
                install_runtime_metrics
            install_runtime_metrics()
            if self._lag_probe is None:
                self._lag_probe = EventLoopLagProbe()
            await self._lag_probe.start()
        return bound

    async def stop(self) -> None:
        if self._http is not None:
            await self._http.stop()
            self._http = None
        if self._lag_probe is not None:
            await self._lag_probe.stop()
        await self.audit.stop()

    # -- embedded client (reference server.go:317-364, pkg/inmemory) ---------

    def get_embedded_client(self, user: str = "", groups: Optional[list] = None,
                            extra: Optional[dict] = None) -> "EmbeddedClient":
        return EmbeddedClient(self.handler, user=user, groups=groups or [],
                              extra=extra or {})


class EmbeddedClient:
    """In-process client with auth-header-injecting transport
    (reference server.go:377-403 + inmemory/transport.go)."""

    def __init__(self, handler: Handler, user: str, groups: list, extra: dict):
        self._transport = HandlerTransport(handler)
        self.user = user
        self.groups = groups
        self.extra = extra

    async def request(self, method: str, target: str, body: bytes = b"",
                      headers: Optional[list] = None) -> Response:
        h = Headers(headers or [])
        if self.user:
            h.set(REMOTE_USER_HEADER, self.user)
            for g in self.groups:
                h.add(REMOTE_GROUP_HEADER, g)
            for k, values in self.extra.items():
                for v in values:
                    h.add(REMOTE_EXTRA_PREFIX + k, v)
        if "Accept" not in h:
            h.set("Accept", "application/json")
        if body and "Content-Type" not in h:
            h.set("Content-Type", "application/json")
        return await self._transport.round_trip(
            Request(method=method, target=target, headers=h, body=body))

    # convenience verbs
    async def get(self, target: str, **kw) -> Response:
        return await self.request("GET", target, **kw)

    async def post(self, target: str, obj: dict, **kw) -> Response:
        return await self.request("POST", target, body=json.dumps(obj).encode(), **kw)

    async def put(self, target: str, obj: dict, **kw) -> Response:
        return await self.request("PUT", target, body=json.dumps(obj).encode(), **kw)

    async def delete(self, target: str, **kw) -> Response:
        return await self.request("DELETE", target, **kw)
