"""Proxy server: handler-chain assembly and the reverse proxy
(reference pkg/proxy/server.go; this package's reference proxy/server.py,
trimmed to the read path).

Chain (bottom-up, reference server.go:153-160):
  PanicRecovery -> HTTPLogging -> RequestInfo -> Authentication ->
  Authorization -> ReverseProxy(upstream, ModifyResponse=FilterResp)

plus /readyz and /livez health endpoints, the authenticated /metrics
scrape and /debug surfaces (traces, decisions, flight, timeline,
workload, profile), the flight recorder with its SLO burn rates
(utils/devtel.py), and the embedded in-process client with
header-injecting transport (reference server.go:282-403 and
pkg/inmemory).

`ProxyServer(Options(spicedb_endpoint="torch://"))` serves on the CUDA
card through the batched `torch://` endpoint; `torch://?device=cpu` runs
the kernels' plain twins on the CPU.  `enable_dual_writes()` wires the
dual-write workflow engine (authz/distributedtx, a SQLite journal at
`workflow_database_path` or an in-memory one for "") into the chain, so
Update rules write through it; without it an update rule answers 500
"update engine not configured", as in the reference.

With `data_dir` the store is durable (spicedb/persist): recovered from
the newest checkpoint and the WAL tail before the endpoint is built,
journaled from then on, checkpointed by a loop that rides `start()` and
`stop()`, and published to read replicas at the authenticated
`/replication/*` routes (spicedb/replication `ReplicationHub`).  With
`replicate_from` the proxy is such a replica: an in-memory store that a
`ReplicaFollower` bootstraps from the leader's checkpoint and tails,
serving reads at bounded staleness (`X-Authz-Min-Revision` waits, then
forwards or answers 503) and forwarding update verbs to the leader.
`/debug/replication` shows either role.

Failover (spicedb/replication/failover.py): a follower with
`promote_data_dir` is promoted by `POST /replication/promote` or, with
`promote_on_leader_loss`, by the election its leader-loss watchdog runs
over `replica_peers` (`/replication/status` is the vote); a leader with
peers probes them for a newer incarnation at start and then
periodically, and a fenced ex-leader demotes itself into a follower of
the new leader and replays its unshipped WAL tail through
`POST /replication/rejoin`.  With `serve_replication` a follower relays
the log it applies from a byte mirror (`mirror_dir`), so further
followers chain off it.  The promoted and the rejoined proxy keep their
endpoint: the device graph follows the store through its delta and
reset listeners.

Sharding (spicedb/sharding): with `shards` > 1 the tuple space splits
by resource type (`partition_map`, `type=shard` pairs) across that many
in-process leaders behind a `ShardedEndpoint`, each over its own store
(with a data dir, its own WAL and checkpoint lineage under
`<data-dir>/shard-<k>`) and, over `torch://`, its own graph on the card.
The map is validated against every permission's and rule's footprint
closure before any graph is built (`RouterConfigError`, SL007);
responses carry the revision VECTOR as their token, a token component
ahead of its shard answers 503, and `/debug/sharding` shows the map and
the shard revisions.  Sharding excludes `replicate_from`, and a sharded
proxy serves no replication (each shard is its own leader).

Fleet tracing: every request's trace is stamped with this node's tier
(leader, follower or hub) and joins the caller's trace when an internal
hop (the router, a follower forwarding to its leader) sends the
X-Authz-* propagation headers; the forward to the leader is a hop span
of its own.  With `fleet_peers` the node merges its own and its peers'
traces, flight recorders, workload and metrics at /debug/fleet
(utils/fleet.py), and /debug/tail ranks where the tail lives in that
merge (utils/tailexplain.py).
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import inspect
import json
import logging
import os
import ssl
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional
from urllib.parse import urlsplit

from ..authz.middleware import (
    FILTERER_KEY,
    forbidden_response,
    with_authorization,
)
from ..authz.responsefilterer import FilterError
from ..config import proxyrule
from ..rules.engine import MapMatcher
from ..spicedb import replication as repl
from ..spicedb.endpoints import Bootstrap, PermissionsEndpoint, create_endpoint
from ..utils import features, timeline, tracing
from ..utils.admission import (
    READ_ONLY_VERBS,
    AdmissionRejectedError,
    LoadShedder,
)
from ..utils.audit import (
    AuditEvent,
    AuditSink,
    LEVEL_METADATA,
    OUTCOME_ALLOWED,
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

# health and introspection endpoints are not themselves traced (a scrape
# of /debug/traces must not evict a real slow trace from the recorder)
_UNTRACED_PATHS = frozenset(
    ("/metrics", "/debug", "/readyz", "/livez", "/healthz"))


def _untraced(path: str) -> bool:
    """Every debug surface stays untraced, the index and unknown names
    (which answer 404) included; so does the replication API (a
    follower's long-poll parks for tens of seconds by design and would
    evict every real slow trace)."""
    return (path in _UNTRACED_PATHS or path.startswith("/debug/")
            or path == "/replication" or path.startswith("/replication/"))


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
    # shed reads also while an SLO burns on both horizons (needs an SLO)
    shed_slo_burn: bool = False
    # device telemetry and the flight recorder (utils/devtel.py): window
    # length and ring size of the per-window snapshots at /debug/flight,
    # and the SLOs whose burn rates they carry: slo_check_p99_ms the
    # latency target (0 disables it), slo_objective the allowed fraction
    # of requests slower than it, slo_error_rate the allowed 5xx
    # fraction (0 disables it)
    flight_window_s: float = 10.0
    flight_windows: int = 64
    slo_check_p99_ms: float = 0.0
    slo_objective: float = 0.01
    slo_error_rate: float = 0.0
    # the card's memory rate in GB/s for the timeline's roofline
    # fraction (utils/timeline.py); 0 detects it from the card
    device_hbm_peak_gbps: float = 0.0
    # dual writes (enable_dual_writes): the workflow journal, "" for an
    # in-memory one, and the lock mode of rules that name none
    workflow_database_path: str = ""
    lock_mode_default: str = proxyrule.PESSIMISTIC_LOCK_MODE
    # durable relationship store (spicedb/persist): "" = in-memory only.
    # With a data dir, the store is recovered from the newest checkpoint
    # + WAL tail at construction, every commit is journaled, and a
    # periodic checkpoint loop runs with the server
    data_dir: str = ""
    wal_fsync: str = "interval"  # always | interval | never
    checkpoint_interval: float = 300.0
    # WAL-shipping replication (spicedb/replication; killswitch: the
    # REPLICATION switch).  Leader side: with a data dir, the authed
    # /replication/* API serves the live WAL segments + checkpoints.
    # Follower side: replicate_from names the leader's base URL — the
    # server bootstraps its (in-memory) store from the leader's newest
    # checkpoint, tails WAL segments, serves read-only traffic at bounded
    # staleness, and forwards update verbs to the leader (or rejects them
    # 503 when forwarding is off)
    replicate_from: str = ""
    # how long a read carrying X-Authz-Min-Revision waits for the tail
    # to catch up before it is forwarded to the leader / rejected
    replica_wait_ms: float = 2000.0
    replica_forward: bool = True
    # identity the follower presents to the leader (header authn; the
    # leader must trust the follower's transport path)
    replica_user: str = "system:replica"
    # shed read-only traffic once the follower is this many seconds
    # stale (0 = disabled)
    shed_replica_lag_s: float = 0.0
    # transport seam to the leader (tests inject an in-process
    # HandlerTransport); None = H11Transport(replicate_from)
    leader_transport: Optional[Transport] = None
    # failover (spicedb/replication/failover.py).  serve_replication:
    # this FOLLOWER also serves /replication/* from a byte mirror of what
    # it applies, so further followers chain off it (fan-out trees).
    # promote_data_dir: the data dir this follower owns once promoted
    # (needed by /replication/promote and promote_on_leader_loss).
    # promote_on_leader_loss: a watchdog that detects a dead upstream
    # and runs the election (highest adopted revision wins, ties break
    # on the smallest replica id) over replica_peers, the base URLs of
    # the other proxies: election candidates for a follower, fence
    # probes for a (possibly resurrected) leader
    serve_replication: bool = False
    mirror_dir: str = ""  # "" with serve_replication => private tempdir
    promote_data_dir: str = ""
    promote_on_leader_loss: bool = False
    leader_loss_grace_s: float = 5.0
    replica_peers: list = field(default_factory=list)
    # transport seam: url -> Transport for peer status probes and
    # repoints; unlisted peers dial HTTP
    peer_transports: Optional[dict] = None
    # this proxy's identity in elections, /replication/status and
    # /debug/replication (minted per process when empty); the election
    # tie-break orders on it
    replica_id: str = ""
    # tuple-space sharding (spicedb/sharding; killswitch: the SHARDING
    # switch).  shards > 1 splits the tuple space by resource type
    # across that many independent in-process leaders — each its own
    # store and (with a data dir) its own WAL/checkpoint lineage under
    # <data-dir>/shard-<k> — behind a ShardedEndpoint.  partition_map is
    # the `type=shard` assignment string; the partition is validated
    # against every permission's and rule's relation_footprint closure
    # at construction (a closure spanning two shards refuses to boot)
    shards: int = 1
    partition_map: str = ""
    # fleet tracing: base URLs of the other fleet members; a node given
    # peers serves the merged cross-process view at /debug/fleet (it
    # fans out to each member's /debug/traces, /debug/flight,
    # /debug/workload and /metrics)
    fleet_peers: list = field(default_factory=list)


class ProxyServer:
    """The assembled proxy (reference pkg/proxy/server.go:41-164)."""

    def __init__(self, opts: Options):
        if opts.upstream_transport is None:
            raise ValueError("upstream_transport (kube-apiserver seam) is required")
        self.opts = opts
        configs = list(opts.rule_configs)
        if opts.rules_yaml:
            configs.extend(proxyrule.parse(opts.rules_yaml))
        # durable store: recover BEFORE endpoint construction and attach
        # BEFORE bootstrap so the bootstrap load itself is journaled;
        # bootstrap-once then skips re-applying it onto recovered state
        self.persistence = None
        endpoint_kwargs = dict(opts.endpoint_kwargs)
        # sharding: N independent in-process leaders behind a
        # ShardedEndpoint.  The SHARDING switch is the killswitch — off,
        # opts.shards is inert and the proxy is exactly single-shard
        self.sharding = None           # PartitionMap when sharded
        self._shard_persistence = []   # per-shard PersistenceManagers
        sharded_on = False
        if opts.shards > 1:
            from ..spicedb import sharding as shrd
            if urlsplit(opts.spicedb_endpoint).scheme not in (
                    "embedded", "torch"):
                raise ValueError(
                    "--shards requires a store-backed endpoint "
                    "(embedded:// or torch://)")
            if opts.replicate_from:
                raise ValueError(
                    "--shards is exclusive with --replicate-from: a "
                    "follower tails ONE leader's log; run one follower "
                    "per shard leader instead")
            sharded_on = shrd.enabled()
            if not sharded_on:
                logger.info("shards=%d set but the Sharding switch is "
                            "off; running single-shard", opts.shards)
        if sharded_on:
            from ..spicedb.sharding import (
                PartitionMap,
                build_sharded_endpoint,
            )
            from ..spicedb.store import TupleStore
            pmap = PartitionMap.parse(opts.partition_map,
                                      n_shards=opts.shards)
            stores = []
            if opts.data_dir and features.DURABLE_STORE:
                from ..spicedb.persist import PersistenceManager
                for k in range(opts.shards):
                    mgr = PersistenceManager(
                        os.path.join(opts.data_dir, f"shard-{k}"),
                        fsync=opts.wal_fsync,
                        checkpoint_interval=opts.checkpoint_interval)
                    store = mgr.recover()
                    mgr.attach(store)
                    self._shard_persistence.append(mgr)
                    stores.append(store)
            else:
                if opts.data_dir:
                    logger.info("data_dir %r set but the DurableStore "
                                "switch is off; running in-memory",
                                opts.data_dir)
                stores = [TupleStore() for _ in range(opts.shards)]
            # a hard startup error when any footprint closure spans
            # shards (SL007): RouterConfigError before any graph is built
            self.endpoint: PermissionsEndpoint = build_sharded_endpoint(
                opts.spicedb_endpoint, opts.bootstrap, pmap, stores,
                rule_configs=configs, **endpoint_kwargs)
            self.sharding = pmap
        if opts.data_dir and not sharded_on:
            if features.DURABLE_STORE:
                from ..spicedb.persist import PersistenceManager
                self.persistence = PersistenceManager(
                    opts.data_dir, fsync=opts.wal_fsync,
                    checkpoint_interval=opts.checkpoint_interval)
                store = self.persistence.recover()
                self.persistence.attach(store)
                endpoint_kwargs["store"] = store
            else:
                logger.info("data_dir %r set but the DurableStore switch "
                            "is off; running in-memory", opts.data_dir)
        # WAL-shipping replication.  Follower mode: an in-memory store the
        # ReplicaFollower bootstraps from the leader's newest checkpoint
        # and tails, built BEFORE the endpoint so the device graph and the
        # decision cache ride the store's listener hooks exactly as they
        # do on a leader.  Leader mode: the hub publishes the data dir.
        # The REPLICATION switch off constructs neither, and the proxy is
        # exactly single-node.
        self.replication = None        # ReplicaFollower (follower mode)
        self.replication_hub = None    # ReplicationHub (leader mode)
        self.fanout_hub = None         # FanoutHub (follower fan-out)
        self._leader_transport: Optional[Transport] = None
        # failover (spicedb/replication/failover.py)
        self._watchdog = None          # LeaderLossWatchdog (follower)
        self._fence_monitor = None     # FenceMonitor (leader)
        self._promote_lock = asyncio.Lock()
        self._peer_transport_cache: dict = {}
        self.replica_id = (opts.replica_id
                           or f"replica-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        if self.persistence is not None and repl.enabled():
            # attach AFTER the persistence manager, so the WAL append
            # precedes every long-poll wakeup
            self.replication_hub = repl.ReplicationHub(
                self.persistence._store, self.persistence)
            self.replication_hub.attach()
        if opts.replicate_from and repl.enabled():
            if self.persistence is not None:
                raise ValueError(
                    "--replicate-from is exclusive with --data-dir: a "
                    "follower re-bootstraps from its leader and must not "
                    "journal the leader's log as its own")
            from ..spicedb.store import TupleStore
            store = TupleStore()
            endpoint_kwargs["store"] = store
            # a follower takes the bootstrap SCHEMA only: relationships
            # are the leader's state and arrive via replication — a
            # locally-applied bootstrap would advance the revision past 0
            # and the follower could never anchor the leader's log to it
            if opts.bootstrap is not None:
                opts = dataclasses.replace(
                    opts, bootstrap=Bootstrap(
                        schema_text=opts.bootstrap.schema_text))
                self.opts = opts
            from .httpcore import H11Transport
            self._leader_transport = (opts.leader_transport
                                      or H11Transport(opts.replicate_from))
            self.replication = repl.ReplicaFollower(
                store, self._leader_transport,
                identity=opts.replica_user,
                replica_id=self.replica_id,
                upstream_url=opts.replicate_from)
            if opts.serve_replication:
                # fan-out tree: this follower also serves /replication/*
                # from a byte mirror of what it applies
                import tempfile
                from ..spicedb.replication import failover as replfo
                mirror = (opts.mirror_dir or tempfile.mkdtemp(
                    prefix="authz-replication-mirror-"))
                self.fanout_hub = replfo.FanoutHub(self.replication,
                                                   mirror)
        elif opts.replicate_from:
            logger.info("replicate_from %r set but the Replication switch "
                        "is off; running single-node", opts.replicate_from)
        if not sharded_on:
            self.endpoint = create_endpoint(
                opts.spicedb_endpoint, bootstrap=opts.bootstrap,
                **endpoint_kwargs)
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
        if self.persistence is not None and self.persistence.recovered:
            info = self.persistence.recovery_info
            self.audit.emit(AuditEvent(
                stage="recovery", decision=OUTCOME_ALLOWED, backend=backend,
                message=(f"recovered store at revision {info.get('revision')}"
                         f" (checkpoint rev {info['checkpoint_revision']},"
                         f" {info['replayed_records']} WAL records,"
                         f" {info['torn_records']} torn,"
                         f" {info['idempotency_keys']} idempotency keys)"
                         f" in {info['total_s']}s")))
        # exposed mutable matcher (reference server.go:145-146: e2e tests
        # swap rule sets at runtime through the *Matcher pointer)
        self.matcher = MapMatcher(configs)
        self.rest_mapper = CachingRESTMapper(opts.upstream_transport)
        self.workflow_client = None  # wired by enable_dual_writes()
        self._worker = None
        self.authenticator: Authenticator = AuthenticatorChain(
            opts.authenticators if opts.authenticators is not None
            else [HeaderAuthenticator(), ClientCertAuthenticator()])
        # the chain's closures read self.flight at request time, so it
        # exists before the chain is built; the recorder itself is built
        # after, because building the chain registers the phase histogram
        # whose cumulative counts the recorder primes its baseline from.
        # Built eagerly so /debug/flight serves without start(); its
        # window task rides start/stop
        self.flight = None
        self.handler = self._build_chain()
        if opts.enable_metrics:
            self.flight = self._make_flight_recorder()
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
            shed_on_burn=opts.shed_slo_burn,
            retry_after_s=opts.shed_retry_after_s,
            depth_fn=depth_fn,
            burning_fn=(lambda: self.flight.burning()
                        if self.flight is not None else []),
            # a stale replica sheds reads before serving stale answers
            shed_lag_s=(opts.shed_replica_lag_s
                        if self.replication is not None else 0.0),
            lag_fn=(self.replication.lag_seconds
                    if self.replication is not None else None))
        # off-loop rebuilds prewarm their candidate generations when
        # compile prewarm is on, so a post-swap first request captures
        # nothing.  The flag is set on the endpoint that owns it: the
        # wrappers forward reads but would keep a write for themselves
        # A sharded endpoint prewarms every shard's graph
        if opts.prewarm_compiles:
            roots = (list(self.endpoint.shards)
                     if self.sharding is not None else [self.endpoint])
            for inner in roots:
                while (inner is not None
                       and "prewarm_rebuilds" not in vars(inner)):
                    inner = getattr(inner, "inner", None)
                if inner is not None:
                    inner.prewarm_rebuilds = True
        # unconditional: 0 restores the card detection, so a server built
        # with the default never inherits an earlier server's peak
        timeline.set_hbm_peak(opts.device_hbm_peak_gbps)
        self._http: Optional[HttpServer] = None
        self._lag_probe = None

    @property
    def _tier(self) -> str:
        """Fleet tracing tier: stamped on every trace this node records
        and appended to the X-Authz-Tier-Path it forwards.  A fan-out hub
        is a follower that also serves /replication/* to further
        followers.  Recomputed per read — promotion turns a follower into
        a leader in place, and the tier follows the role."""
        return ("hub" if self.fanout_hub is not None
                else "follower" if self.replication is not None
                else "leader")

    def _make_flight_recorder(self):
        from ..utils import devtel
        slos = []
        if self.opts.slo_check_p99_ms > 0:
            slos.append(devtel.Slo(
                "latency_p99", "latency",
                objective=self.opts.slo_objective,
                threshold_s=self.opts.slo_check_p99_ms / 1e3))
        if self.opts.slo_error_rate > 0:
            slos.append(devtel.Slo(
                "error_rate", "error",
                objective=self.opts.slo_error_rate))
        def stats_fn() -> dict:
            # follower lag rides every flight window beside the latency
            out = dict(getattr(self.endpoint, "stats", None) or {})
            if self.replication is not None:
                out["replica_lag_revisions"] = self.replication.lag_revisions()
                out["replica_lag_seconds"] = round(
                    self.replication.lag_seconds(), 3)
            return out

        return devtel.FlightRecorder(
            window_s=self.opts.flight_window_s,
            capacity=self.opts.flight_windows,
            slos=slos,
            stats_fn=stats_fn)

    def enable_dual_writes(self) -> None:
        """Wire the dual-write workflow engine into the chain (reference
        server.py:582-589); `start()` starts its worker."""
        from ..authz.distributedtx.client import setup_workflow_engine
        self.workflow_client, self._worker = setup_workflow_engine(
            self.endpoint, self.opts.upstream_transport,
            self.opts.workflow_database_path,
            default_lock_mode=self.opts.lock_mode_default,
            audit=self.audit)
        self.handler = self._build_chain()

    # -- debug surfaces ------------------------------------------------------
    # All authenticated-only (the chain checks the user first), all JSON,
    # all error-handled by `_serve_debug` (reference server.py:591-805).

    def _debug_surfaces(self) -> dict:
        return {
            "traces": ("slowest retained request traces with per-phase "
                       "spans", self._debug_traces),
            "decisions": ("recent authorization decisions from the audit "
                          "ring, newest first", self._debug_decisions),
            "flight": ("flight recorder: per-window telemetry snapshots "
                       "(phase quantiles, queue depths, HBM ledger, "
                       "occupancy) + SLO burn rates", self._debug_flight),
            "timeline": ("dispatch timeline as chrome trace-event JSON "
                         "(load in Perfetto): pack/kernel/transfer/extract/"
                         "rebuild/compile slices + overlap/roofline/stall "
                         "summary", self._debug_timeline),
            "workload": ("per-(resource type, permission) cost "
                         "attribution: device time, measured sweep "
                         "depth, occupancy, cache hit rate, oracle "
                         "fraction, Leopard-index candidates",
                         self._debug_workload),
            "profile": ("on-demand sampling profiler: ?seconds=N "
                        "(capped) wall-clock stack capture across all "
                        "threads, collapsed-stack + Perfetto output",
                        self._debug_profile),
            "replication": ("replication state: leader (served segments, "
                            "long-poll waiters) or follower (applied "
                            "revision, lag, cursor, bootstraps)",
                            self._debug_replication),
            "sharding": ("partition map + per-shard revisions of the "
                         "in-process sharded endpoint",
                         self._debug_sharding),
            "fleet": ("merged fleet view: cross-process trace assembly, "
                      "per-tier latency attribution, SLO burn roll-up "
                      "across --fleet-peers", self._debug_fleet),
            "tail": ("tail explainer: p99-vs-p50 population diff of the "
                     "merged fleet traces, ranked by which (tier, "
                     "serving stage) component grew the most in the "
                     "tail", self._debug_tail),
        }

    async def _serve_debug(self, req: Request) -> Response:
        surfaces = self._debug_surfaces()
        if req.path in ("/debug", "/debug/"):
            return json_response(200, {
                "surfaces": {f"/debug/{name}": desc
                             for name, (desc, _fn) in sorted(
                                 surfaces.items())}})
        entry = surfaces.get(req.path[len("/debug/"):])
        if entry is None:
            return json_response(404, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure",
                "message": f"unknown debug surface {req.path!r}; "
                           f"GET /debug for the index",
                "reason": "NotFound", "code": 404})
        try:
            fn = entry[1]
            out = fn(req) if getattr(fn, "_wants_request", False) else fn()
            if inspect.isawaitable(out):
                out = await out
            return json_response(200, out)
        except Exception as e:
            logger.exception("debug surface %s failed", req.path)
            return json_response(500, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure",
                "message": f"debug surface {req.path} failed: {e}",
                "code": 500})

    def _debug_traces(self) -> dict:
        return {"capacity": tracing.RECORDER.capacity,
                "traces": tracing.RECORDER.snapshot()}

    async def _debug_fleet(self, req: Request) -> dict:
        from ..utils import fleet
        peers = list(self.opts.fleet_peers)
        if not peers:
            return {"enabled": False,
                    "reason": "no --fleet-peers configured",
                    "tier": self._tier}
        # re-assert the already-authenticated caller toward the peers
        # (the trust model of _forward_to_leader: the peers trust this
        # node's transport path)
        headers = []
        user = req.context.get("user")
        if user is not None:
            headers.append((REMOTE_USER_HEADER, user.name))
            for g in user.groups:
                headers.append((REMOTE_GROUP_HEADER, g))
        members = await fleet.collect_fleet(
            peers, headers=headers,
            transports=self.opts.peer_transports)
        local = {"url": "local", "error": None,
                 "traces": self._debug_traces()["traces"],
                 "flight": self._debug_flight(),
                 "workload": self._debug_workload(),
                 "skew_s": (self.replication.clock_skew_s()
                            if self.replication is not None else None),
                 "lag_s": (self.replication.lag_seconds()
                           if self.replication is not None else None)}
        merged = fleet.merge_fleet([local] + members)
        merged["enabled"] = True
        merged["tier"] = self._tier
        return merged
    _debug_fleet._wants_request = True

    async def _debug_tail(self, req: Request) -> dict:
        from ..utils import tailexplain
        if not tailexplain.enabled():
            return {"enabled": False,
                    "reason": "TailExplain feature gate disabled"}
        merged = await self._debug_fleet(req)
        if merged.get("enabled") is not True:
            # no fleet peers: explain the local trace population alone
            # (single-segment traces carry no cross-tier attribution,
            # so the report says how many traces were usable)
            from ..utils import fleet
            local = {"url": "local", "error": None,
                     "traces": self._debug_traces()["traces"]}
            merged = fleet.merge_fleet([local])
        report = tailexplain.explain(merged)
        report["tier"] = self._tier
        return report
    _debug_tail._wants_request = True

    def _debug_decisions(self) -> dict:
        return {"level": self.audit.level,
                "ring_capacity": self.audit.ring_capacity,
                "sample_every": self.audit.sample_every,
                "decisions": self.audit.recent()}

    def _debug_flight(self) -> dict:
        from ..utils import devtel
        if self.flight is None:
            return {"enabled": False, "windows": []}
        if not devtel.enabled():
            # built but switched off: the window task never starts, and
            # the payload says why the ring stays empty
            return {"enabled": False,
                    "reason": "DeviceTelemetry feature gate disabled",
                    "windows": self.flight.snapshots()}
        return {"enabled": True,
                "window_s": self.flight.window_s,
                "capacity": self.flight.capacity,
                "slos": self.flight.describe_slos(),
                "burning": self.flight.burning(),
                "windows": self.flight.snapshots()}

    def _debug_timeline(self) -> dict:
        if not timeline.enabled():
            # a valid, empty chrome-trace envelope that says why
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "otherData": {
                        "reason": "Timeline feature gate disabled"}}
        return timeline.chrome_trace()

    def _debug_workload(self) -> dict:
        from ..utils import workload
        if not workload.enabled():
            return {"enabled": False,
                    "reason": "KernelIntrospect feature gate disabled"}
        return dict(workload.WORKLOAD.payload(), enabled=True)

    def _debug_replication(self) -> dict:
        if self.replication_hub is not None:
            out = self.replication_hub.snapshot()
            if self._fence_monitor is not None:
                out["fence_monitor"] = dict(self._fence_monitor.stats)
            return out
        if self.replication is not None:
            out = self.replication.snapshot()
            if self.fanout_hub is not None:
                out["fanout"] = self.fanout_hub.snapshot()
            if self._watchdog is not None:
                out["watchdog"] = dict(self._watchdog.stats,
                                       grace_s=self._watchdog.grace_s)
            return out
        return {"enabled": False,
                "reason": ("Replication feature gate disabled"
                           if not repl.enabled() else
                           "not configured (leader needs --data-dir, "
                           "follower needs --replicate-from)")}

    def _debug_sharding(self) -> dict:
        if self.sharding is None:
            from ..spicedb import sharding as shrd
            return {"enabled": False,
                    "reason": ("Sharding feature gate disabled"
                               if not shrd.enabled() else
                               "not configured (--shards N with a "
                               "store-backed endpoint)")}
        return {"enabled": True,
                "partition_map": self.sharding.describe(),
                "revision_vector": self.endpoint.revision_vector().encode(),
                "shard_revisions": {
                    str(k): store.revision
                    for k, store in
                    enumerate(self.endpoint.shard_stores())}}

    async def _debug_profile(self, req: Request) -> dict:
        from urllib.parse import parse_qs, urlsplit

        from ..utils import profiler
        if not profiler.enabled():
            return {"enabled": False,
                    "reason": "Profiler feature gate disabled"}
        q = parse_qs(urlsplit(req.target).query)
        try:
            seconds = float((q.get("seconds") or ["1"])[0])
        except ValueError:
            seconds = 1.0
        try:
            # the capture blocks on a worker thread, so the event loop
            # keeps serving and is sampled doing so
            out = await asyncio.to_thread(profiler.capture, seconds)
        except profiler.ProfilerBusy as e:
            return {"enabled": True, "error": str(e)}
        return dict(out, enabled=True)
    _debug_profile._wants_request = True

    # -- replication serving (spicedb/replication) ---------------------------

    async def _serve_replication(self, req: Request) -> Response:
        """Replication API (authenticated, like /metrics): manifest /
        segment / checkpoint bytes from the leader hub or a follower's
        fan-out hub, plus the failover control surface (status /
        promote / rejoin).  A proxy with no replication role at all —
        including the REPLICATION switch off — answers 503 exactly as a
        single-node proxy always has."""
        path = req.path
        if (self.replication_hub is None and self.fanout_hub is None
                and self.replication is None):
            return json_response(503, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 503,
                "reason": "ServiceUnavailable",
                "message": "replication is not served here: this proxy "
                           "has no durable data dir (--data-dir) or is "
                           "itself a follower"})
        if path == "/replication/status":
            return json_response(200, self._replication_status())
        if path == "/replication/promote":
            return await self._serve_promote(req)
        if path == "/replication/rejoin":
            return await self._serve_rejoin(req)
        hub = self.replication_hub or self.fanout_hub
        if hub is None:
            return json_response(503, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 503,
                "reason": "ServiceUnavailable",
                "message": "replication artifacts are not served here: "
                           "this follower runs without "
                           "--serve-replication"})
        if path == "/replication/manifest":
            return await hub.serve_manifest(req)
        if path.startswith("/replication/segment/"):
            return await hub.serve_segment(req, path.rsplit("/", 1)[1])
        if path.startswith("/replication/checkpoint/"):
            return await hub.serve_checkpoint(req, path.rsplit("/", 1)[1])
        return json_response(404, {
            "kind": "Status", "apiVersion": "v1", "metadata": {},
            "status": "Failure", "reason": "NotFound", "code": 404,
            "message": f"unknown replication endpoint {path!r}; use "
                       f"/replication/manifest, /replication/segment/"
                       f"<name>, /replication/checkpoint/<name>, "
                       f"/replication/status, /replication/promote, "
                       f"/replication/rejoin"})

    def _replication_status(self) -> dict:
        """Election / fence-probe surface: role, incarnation, revision."""
        if self.replication_hub is not None:
            hub = self.replication_hub
            return {"role": "leader", "replica_id": self.replica_id,
                    "leader_id": hub.leader_id,
                    "incarnation": hub.incarnation,
                    "revision": hub.store.revision,
                    "fenced_by": hub.fenced_by}
        r = self.replication
        if r is not None:
            return {"role": "follower", "replica_id": r.replica_id,
                    "leader_id": r.max_leader_id or r.leader_id,
                    "incarnation": r.max_incarnation,
                    "revision": r.store.revision,
                    "state": r.state,
                    "upstream": self.opts.replicate_from,
                    "serves_replication": self.fanout_hub is not None,
                    "fenced_by": None}
        return {"role": "single"}  # pragma: no cover - guarded above

    def _replication_privileged(self, req: Request) -> Optional[Response]:
        """The mutating failover control endpoints (promote / rejoin)
        change who takes writes or write tuples directly — unlike the
        read-only artifact/status surfaces (any authenticated principal,
        same trust level as /metrics), they require the replication
        identity (--replica-user) or system:masters.  None = allowed."""
        user = req.context.get("user")
        if (user is not None
                and (user.name == self.opts.replica_user
                     or "system:masters" in (user.groups or ()))):
            return None
        return json_response(403, {
            "kind": "Status", "apiVersion": "v1", "metadata": {},
            "status": "Failure", "reason": "Forbidden", "code": 403,
            "message": f"replication control endpoints require the "
                       f"replication identity "
                       f"({self.opts.replica_user!r}) or membership in "
                       f"system:masters"})

    async def _serve_promote(self, req: Request) -> Response:
        """POST /replication/promote: promote this follower to leader
        (spicedb/replication/failover.py)."""
        denied = self._replication_privileged(req)
        if denied is not None:
            return denied
        if req.method != "POST":
            return json_response(405, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 405,
                "message": "promotion is POST /replication/promote"})
        from ..spicedb.replication import failover as replfo
        try:
            info = await replfo.promote_follower(self)
        except replfo.PromotionError as e:
            return json_response(e.status, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": e.status,
                "reason": ("Conflict" if e.status == 409
                           else "ServiceUnavailable"),
                "message": str(e)})
        return json_response(200, info)

    async def _serve_rejoin(self, req: Request) -> Response:
        """POST /replication/rejoin: a re-joining ex-leader replays its
        unshipped WAL tail as a batch of TOUCH/DELETE updates.  Applied
        through the normal store write path: journaled, watched, and
        shipped onward to this leader's own followers."""
        denied = self._replication_privileged(req)
        if denied is not None:
            return denied
        hub = self.replication_hub
        if hub is None:
            return json_response(503, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 503,
                "reason": "ServiceUnavailable",
                "message": "rejoin is served by the leader"})
        if hub.fenced_by is not None:
            return json_response(409, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 409, "reason": "Conflict",
                "message": "this leader is itself fenced by incarnation "
                           f"{hub.fenced_by['incarnation']}; rejoin "
                           f"against the newer leader"})
        if req.method != "POST":
            return json_response(405, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 405,
                "message": "rejoin is POST /replication/rejoin"})
        from ..spicedb.store import WriteLimitExceededError
        from ..spicedb.types import (
            RelationshipUpdate,
            UpdateOp,
            parse_relationship,
        )
        try:
            body = json.loads(req.body or b"{}")
            updates = [
                RelationshipUpdate(
                    UpdateOp.DELETE if op == "d" else UpdateOp.TOUCH,
                    parse_relationship(s))
                for op, s in body["updates"]]
        except (KeyError, TypeError, ValueError) as e:
            return json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400,
                "message": f"invalid rejoin payload: {e}"})
        if not updates:
            return json_response(200, {"applied": 0,
                                       "revision": hub.store.revision})
        try:
            # the store write journals (WAL append + fsync policy): off
            # the serving loop like every other store-touching write
            rev = await asyncio.get_running_loop().run_in_executor(
                None, hub.store.write, updates)
        except WriteLimitExceededError as e:
            return json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400, "message": str(e)})
        logger.info("rejoin replay from %s: %d update(s) at revision %d",
                    body.get("from_leader_id", "?"), len(updates), rev)
        return json_response(200, {"applied": len(updates),
                                   "revision": rev})

    def peer_transports(self) -> dict:
        """url -> Transport for each replica_peers entry (tests inject
        via Options.peer_transports; real deployments dial HTTP)."""
        out = {}
        for url in self.opts.replica_peers:
            tr = self._peer_transport_cache.get(url)
            if tr is None:
                tr = (self.opts.peer_transports or {}).get(url)
                if tr is None:
                    from .httpcore import H11Transport
                    tr = H11Transport(url)
                self._peer_transport_cache[url] = tr
            out[url] = tr
        return out

    def repoint_leader(self, url: str) -> None:
        """Point this follower (tail + write forwarding) at a different
        leader — the election loser's path once the winner shows up."""
        tr = self.peer_transports().get(url)
        if tr is None:
            from .httpcore import H11Transport
            tr = H11Transport(url)
        self._leader_transport = tr
        self.opts.replicate_from = url
        if self.replication is not None:
            self.replication.repoint(tr, url)

    def _leader_unavailable(self, message: str) -> Response:
        return json_response(503, {
            "kind": "Status", "apiVersion": "v1", "metadata": {},
            "status": "Failure", "reason": "ServiceUnavailable",
            "code": 503, "message": message,
            "details": {"leader": self.opts.replicate_from,
                        "leaderId": getattr(self.replication, "leader_id",
                                            "")}})

    async def _forward_to_leader(self, req: Request, why: str) -> Response:
        """Relay a request to the leader verbatim, re-asserting the
        follower-authenticated identity as X-Remote-* headers (the
        leader must trust this follower's transport path)."""
        if not self.opts.replica_forward or self._leader_transport is None:
            return self._leader_unavailable(
                f"{why}; write/fresh-read forwarding is disabled — "
                f"retry against the leader")
        up = Headers()
        for k, v in req.headers.items():
            lk = k.lower()
            if lk in ("authorization", "connection", "content-length",
                      "host") or lk.startswith("x-remote-"):
                continue
            up.add(k, v)
        user = req.context.get("user")
        if user is not None:
            up.set(REMOTE_USER_HEADER, user.name)
            for g in user.groups:
                up.add(REMOTE_GROUP_HEADER, g)
            for key, values in (getattr(user, "extra", None) or {}).items():
                for v in values:
                    up.add(REMOTE_EXTRA_PREFIX + key, v)
        try:
            # fleet tracing: the leader joins this request's trace, and
            # the hop span separates network time from the leader's
            # (no span, no headers, when propagation is switched off)
            with tracing.hop_span("hop.forward_to_leader",
                                  tier=self._tier, why=why) as hop:
                for hk, hv in hop.headers.items():
                    up.set(hk, hv)
                resp = await self._leader_transport.round_trip(Request(
                    method=req.method, target=req.target, headers=up,
                    body=req.body))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            return self._leader_unavailable(
                f"{why}; forwarding to the leader failed: {e}")
        if self.replication is not None:
            self.replication.stats["forwarded"] = (
                self.replication.stats.get("forwarded", 0) + 1)
        resp.headers.set("X-Authz-Forwarded-To", "leader")
        return resp

    def _min_revision(self, req: Request):
        """(min revision or None, 400 response or None) from the
        X-Authz-Min-Revision header."""
        raw = req.headers.get(repl.MIN_REVISION_HEADER)
        if not raw:
            return None, None
        try:
            return int(raw), None
        except ValueError:
            return None, json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400,
                "message": f"invalid {repl.MIN_REVISION_HEADER} "
                           f"header {raw!r}: want an integer revision"})

    async def _leader_gate(self, req: Request,
                           verb: str) -> Optional[Response]:
        """Leader-side admission.  (1) Fencing tripwire: an ex-leader
        that has observed a newer incarnation refuses every update verb;
        reads keep serving.  (2) ZedToken honoring: a read carrying
        X-Authz-Min-Revision ahead of this leader's revision waits like
        a follower would, then 503s rather than answer below the token.
        None = serve."""
        hub = self.replication_hub
        fen = hub.fenced_by
        if fen is not None and verb not in READ_ONLY_VERBS:
            return json_response(503, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 503,
                "reason": "ServiceUnavailable",
                "message": f"this leader (incarnation {hub.incarnation})"
                           f" has been superseded by incarnation "
                           f"{fen['incarnation']}; update verbs are "
                           f"fenced — retry against the new leader",
                "details": {"fencedBy": fen}})
        min_rev, bad = self._min_revision(req)
        if bad is not None:
            return bad
        if min_rev is not None and min_rev > hub.store.revision:
            if not await hub.wait_for_revision(
                    min_rev - 1, self.opts.replica_wait_ms / 1e3):
                return json_response(503, {
                    "kind": "Status", "apiVersion": "v1", "metadata": {},
                    "status": "Failure", "code": 503,
                    "reason": "ServiceUnavailable",
                    "message": f"revision {min_rev} is not available on "
                               f"this leader (at {hub.store.revision}); "
                               f"the token may predate a failover"})
        return None

    async def _replica_gate(self, req: Request,
                            verb: str) -> Optional[Response]:
        """Follower-mode admission: anything that can mutate goes to the
        leader (allowlist by read verb); a read whose ZedToken is ahead
        of the applied revision waits up to replica_wait_ms, then
        forwards.  None = serve locally."""
        if verb not in READ_ONLY_VERBS:
            return await self._forward_to_leader(
                req, "this proxy is a read replica; update verbs are "
                     "served by the leader")
        min_rev, bad = self._min_revision(req)
        if bad is not None:
            return bad
        if min_rev is None:
            return None
        if not await self.replication.wait_for_revision(
                min_rev, self.opts.replica_wait_ms / 1e3):
            return await self._forward_to_leader(
                req, f"replica at revision "
                     f"{self.replication.store.revision} has not "
                     f"reached requested min-revision {min_rev} "
                     f"within {self.opts.replica_wait_ms:.0f}ms")
        return None

    def _stamp_revision(self, resp: Response) -> None:
        """Every authenticated response from a replicating proxy carries
        the revision it served at — the ZedToken a client threads back
        as X-Authz-Min-Revision to read its writes on any replica."""
        if self.replication_hub is not None:
            resp.headers.set(repl.REVISION_HEADER,
                             str(self.replication_hub.store.revision))
        elif self.replication is not None:
            resp.headers.set(repl.REVISION_HEADER,
                             str(self.replication.store.revision))
        elif self.sharding is not None:
            # a sharded proxy stamps the full revision VECTOR
            resp.headers.set(repl.REVISION_HEADER,
                             self.endpoint.revision_vector().encode())

    def _sharded_gate(self, req: Request) -> Optional[Response]:
        """In-process sharded mode: honor revision-vector ZedTokens.
        Writes commit synchronously here (no replication tail), so any
        token this proxy issued is already satisfied; a component ahead
        of its shard (a token from a lost future, or another fleet) is
        refused 503 rather than served below the token.  None = serve."""
        from ..spicedb.sharding import RevisionVector, RevisionVectorError
        raw = req.headers.get(repl.MIN_REVISION_HEADER)
        if not raw:
            return None
        try:
            vec = RevisionVector.decode(raw)
        except RevisionVectorError as e:
            return json_response(400, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 400,
                "message": f"invalid {repl.MIN_REVISION_HEADER} "
                           f"revision-vector token: {e}"})
        stores = self.endpoint.shard_stores()
        for k, store in enumerate(stores):
            want = vec.component(k)
            if want > store.revision:
                return json_response(503, {
                    "kind": "Status", "apiVersion": "v1", "metadata": {},
                    "status": "Failure", "code": 503,
                    "reason": "ServiceUnavailable",
                    "message": f"revision {want} is not available on "
                               f"shard {k} (at {store.revision}); the "
                               f"token may predate a shard recovery"})
        # a component naming a shard outside this fleet demands a
        # revision no store here can ever satisfy — refuse it rather
        # than silently dropping the client's staleness bound
        unknown = sorted(k for k, v in vec.parts.items()
                         if k >= len(stores) and v > 0)
        if unknown:
            return json_response(503, {
                "kind": "Status", "apiVersion": "v1", "metadata": {},
                "status": "Failure", "code": 503,
                "reason": "ServiceUnavailable",
                "message": f"revision-vector token names shard(s) "
                           f"{unknown} outside this fleet's "
                           f"0..{len(stores) - 1}; the token may come "
                           f"from another fleet or a larger partition "
                           f"map"})
        return None

    # -- chain ---------------------------------------------------------------

    def _build_chain(self) -> Handler:
        cluster_proxy = self._make_cluster_proxy()

        async def failed(req: Request) -> Response:
            return forbidden_response("forbidden: not permitted by proxy rules")

        authorized = with_authorization(
            cluster_proxy, failed, self.rest_mapper, self.endpoint,
            matcher_ref=lambda: self.matcher,
            workflow_client=self.workflow_client,
            audit=self.audit)

        async def authenticated(req: Request) -> Response:
            if _untraced(req.path):
                # scrape and health authn stay out of the serving-stage
                # accounting, whose counts they would dominate
                user = self.authenticator.authenticate(req)
            else:
                with timeline.serving_span("authn"):
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
            # debug introspection surfaces, at the trust level of /metrics:
            # any authenticated principal may read them
            if req.path == "/debug" or req.path.startswith("/debug/"):
                return await self._serve_debug(req)
            # the replication API, at the trust level of /metrics
            if (req.path == "/replication"
                    or req.path.startswith("/replication/")):
                return await self._serve_replication(req)
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
            # leader mode: a fenced ex-leader refuses update verbs, and a
            # ZedToken ahead of this leader's revision waits or 503s
            if self.replication_hub is not None:
                gated = await self._leader_gate(req, verb)
                if gated is not None:
                    return gated
            # follower mode: update verbs forward to the leader, a read
            # whose ZedToken is ahead of the tail waits or forwards —
            # never a stale answer below its min-revision
            if self.replication is not None:
                gated = await self._replica_gate(req, verb)
                if gated is not None:
                    return gated
            # in-process sharded mode: revision-vector tokens are checked
            # per shard component (writes are synchronous, so this is a
            # tripwire for tokens from a lost future, never a wait)
            if self.sharding is not None:
                gated = self._sharded_gate(req)
                if gated is not None:
                    return gated
            try:
                resp = await authorized(req)
            except AdmissionRejectedError as e:
                req.context["authz_outcome"] = OUTCOME_SHED
                return too_many_requests_response(e.retry_after_s, str(e))
            self._stamp_revision(resp)
            return resp

        async def with_request_info(req: Request) -> Response:
            if req.path in ("/readyz", "/livez", "/healthz"):
                lines = ["ok"]
                if req.path == "/readyz":
                    if (self.replication is not None
                            and not self.replication.ever_bootstrapped):
                        # not ready before the FIRST adoption only: a
                        # follower with no adopted state would answer
                        # every read "nothing exists".  A later
                        # re-bootstrap keeps serving the adopted state
                        # and reports degraded below
                        return Response(
                            status=503,
                            body=b"[-] replication: bootstrapping from "
                                 b"leader (no checkpoint adopted yet)")
                    if (self.replication_hub is not None
                            and self.replication_hub.fenced_by
                            is not None):
                        fen = self.replication_hub.fenced_by
                        lines.append(
                            "[!] replication fenced: superseded by "
                            f"incarnation {fen['incarnation']}; update "
                            "verbs are refused")
                    if self.replication is not None:
                        # degraded-but-200 while catching up or cut off
                        # from the leader: bounded-staleness reads are
                        # still correct answers
                        from ..spicedb.replication import follower as f
                        if self.replication.state == f.STATE_DEGRADED:
                            lines.append(
                                "[!] replication degraded: leader "
                                "unreachable, serving reads at revision "
                                f"{self.replication.store.revision}")
                        elif not self.replication.bootstrapped:
                            lines.append(
                                "[!] replication re-bootstrapping: "
                                "serving reads at revision "
                                f"{self.replication.store.revision}")
                        elif self.replication.lag_revisions() > 0:
                            lines.append(
                                "[!] replication catching up: "
                                f"{int(self.replication.lag_revisions())}"
                                " revisions behind the leader")
                    if self.flight is not None:
                        # a burning SLO is an alert, not an outage: the
                        # status stays 200
                        lines += [
                            f"[!] slo {b['slo']} burning: "
                            f"short={b['short']:.2f} long={b['long']:.2f}"
                            for b in self.flight.burning()]
                    if self.shedder.shedding_recently():
                        # shedding is degraded-but-200: the proxy is
                        # protecting itself, and ejecting the pod would
                        # turn deliberate backpressure into a real outage
                        lines.append("[!] admission control shedding "
                                     "read-only traffic (429)")
                return Response(status=200, body="\n".join(lines).encode())
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
            tier_latency = REGISTRY.histogram(
                "authz_tier_seconds",
                "Per-tier request wall time (router, leader, follower, "
                "hub) for fleet latency attribution",
                labels=("tier",))
        else:
            request_counter = request_latency = phase_latency = None
            tier_latency = None

        slow_threshold = self.opts.trace_slow_threshold

        async def with_logging(req: Request) -> Response:
            tr = token = None
            if not _untraced(req.path):
                # trace-id assignment: honor a well-formed caller id so
                # multi-hop traces correlate; anything else gets a fresh
                # id.  Fleet propagation (switch on only): an internal
                # hop carrying X-Authz-Trace-Id JOINS the caller's trace
                # (same id, own spans, tier-stamped) instead of minting;
                # switched off, the fleet headers are never read
                propagate = tracing.propagation_enabled()
                prop_id = None
                if propagate:
                    prop_id = tracing.clean_trace_id(
                        req.headers.get(tracing.PROP_TRACE_HEADER))
                tr, token = tracing.start_trace(
                    trace_id=prop_id or tracing.clean_trace_id(
                        req.headers.get(tracing.TRACE_ID_HEADER)),
                    method=req.method, target=req.target)
                if propagate:
                    incoming = tracing.clean_tier_path(
                        req.headers.get(tracing.PROP_TIER_PATH_HEADER))
                    tr.attrs["tier"] = self._tier
                    tr.attrs["tier_path"] = (
                        incoming + ">" + self._tier if incoming
                        else self._tier)
                    parent = tracing.clean_trace_id(
                        req.headers.get(tracing.PROP_PARENT_HEADER))
                    if prop_id and parent:
                        tr.attrs["parent_span"] = parent
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
                if self.flight is not None:
                    # SLO tallies count proxied (traced) requests only:
                    # probes and introspection must not dilute them
                    self.flight.observe_request(elapsed, resp.status)
                if phase_latency is not None:
                    for phase, secs in tr.phase_durations().items():
                        phase_latency.observe(secs, phase=phase)
                if (tier_latency is not None
                        and tracing.propagation_enabled()):
                    tier_latency.observe(elapsed, tier=self._tier)
                tracing.RECORDER.record(tr)
                if slow_threshold and tr.duration >= slow_threshold:
                    logger.warning("slow request trace: %s",
                                   json.dumps(tr.to_dict(), sort_keys=True))
            if logger.isEnabledFor(logging.INFO):
                logger.info("%s %s -> %d (%.1fms)%s", req.method,
                            req.target, resp.status, elapsed * 1e3,
                            format_request_kv(req)
                            if features.STRUCTURED_REQUEST_LOG else "")
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
            with tracing.span("upstream", phase=True), \
                    timeline.serving_span("kube_upstream"):
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
        warm_start`).  `start()` runs it when the store was recovered
        from a data dir or the prewarm is on; a caller serving through
        the embedded client runs it itself.  A no-op for an endpoint
        with no device graph."""
        warm = getattr(self.endpoint, "warm_start", None)
        if warm is None:
            return
        prewarm = self.opts.prewarm_compiles
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()
        name = ("recovery.graph_rebuild"
                if self.persistence is not None or self._shard_persistence
                else "warm_start")
        with tracing.request_trace(op="warm_start") as tr:
            with tracing.span(name, phase=True):
                await loop.run_in_executor(
                    None, lambda: ctx.run(warm, prewarm=prewarm))
        tracing.RECORDER.record(tr)

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        # a recovered store pays its device-graph build before serving,
        # so the first request after a restart does not absorb it
        if (self.persistence is not None or self._shard_persistence
                or self.opts.prewarm_compiles):
            await self.warm_start()
        if (self.replication_hub is not None and self.opts.replica_peers
                and repl.enabled()):
            # startup fence probe BEFORE the listener opens: a resurrected
            # ex-leader must not accept a write the fleet won't see.  A
            # newer incarnation among the peers demotes this process into
            # a follower of it (its unshipped WAL tail replayed) here
            from ..spicedb.replication import failover as replfo
            if self._fence_monitor is None:
                self._fence_monitor = replfo.FenceMonitor(self)
            try:
                await self._fence_monitor.check_once()
            except Exception:
                logger.exception("startup fence probe failed; serving "
                                 "anyway (header-exchange fencing still "
                                 "guards writes)")
        self._http = HttpServer(self.handler, ssl_context=self.opts.ssl_context)
        bound = await self._http.start(host, port)
        if self.persistence is not None:
            await self.persistence.start()
        for mgr in self._shard_persistence:
            # per-shard checkpoint loops: each shard owns its lineage
            await mgr.start()
        if self._fence_monitor is not None and self.replication_hub is not None:
            self._fence_monitor.start()
        if self.replication is not None:
            # the follower's tail task: the bootstrap happens inside it,
            # so serving starts at once (/readyz answers 503 until the
            # first checkpoint adoption)
            self.replication.start()
        if (self.replication is not None
                and self.opts.promote_on_leader_loss and repl.enabled()):
            # the leader-loss watchdog: election and self-promotion
            from ..spicedb.replication import failover as replfo
            if self._watchdog is None:
                self._watchdog = replfo.LeaderLossWatchdog(
                    self, grace_s=self.opts.leader_loss_grace_s)
            self._watchdog.start()
        if self._worker is not None:
            # the worker's first drain replays dual-write instances left
            # pending by a crash
            await self._worker.start()
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
        if self.flight is not None:
            from ..utils import devtel
            if devtel.enabled():
                await self.flight.start()
        return bound

    async def stop(self) -> None:
        if self._http is not None:
            await self._http.stop()
            self._http = None
        if self._worker is not None:
            await self._worker.stop()
        if self._lag_probe is not None:
            await self._lag_probe.stop()
        if self.flight is not None:
            await self.flight.stop()
        if self._watchdog is not None:
            await self._watchdog.stop()
        if self._fence_monitor is not None:
            await self._fence_monitor.stop()
        if self.replication is not None:
            await self.replication.stop()
        if self.fanout_hub is not None:
            self.fanout_hub.close()
        if self.replication_hub is not None:
            self.replication_hub.detach()
        if self.persistence is not None:
            # final checkpoint: a clean shutdown restarts from the
            # checkpoint alone, with an empty WAL tail
            await self.persistence.stop()
        for mgr in self._shard_persistence:
            await mgr.stop()
        if self.sharding is not None:
            # merged watch streams end with the proxy: their pump threads
            # exit once the shard watchers close
            self.endpoint.close_watches()
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
