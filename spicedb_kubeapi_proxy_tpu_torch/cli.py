"""Command-line entry point of the torch port (this package's reference
cli.py:65-1004, trimmed to what the port serves).

The reference CLI's Complete -> Validate -> NewServer -> Run lifecycle
(cmd/spicedb-kubeapi-proxy/main.go:20-64, pkg/proxy/options.go) with its
word-separator normalization (`--rule_config` == `--rule-config`):

    python -m spicedb_kubeapi_proxy_tpu_torch \\
        --backend-kubeconfig ./backend.yaml \\
        --rule-config ./rules.yaml \\
        --spicedb-bootstrap ./bootstrap.yaml \\
        --secure-port 8443

`--spicedb-endpoint` defaults to `torch://`, which serves on the CUDA
card and raises where there is none; `torch://?device=cpu` (the
kernels' plain twins) and `embedded://` (the host evaluator) run on the
CPU only when asked for.  `grpc://host:port` (`grpcs://`, `http://`,
`https://`, or a scheme-less `host:port`, TLS unless `--spicedb-insecure`)
dials a remote permissions service over gRPC, such as `python -m
spicedb_kubeapi_proxy_tpu_torch.permsd` serving `torch://` on a card for
many proxies, with `--spicedb-token`, `--spicedb-ca-path` and
`--spicedb-skip-verify-ca`; it needs grpcio.  Any other scheme (`jax://`
included) is a `validate` error.

`--decision-cache[-bytes]` puts the decision cache in front of the
endpoint; `--flight-window[s]`, `--slo-*`, `--shed-slo-burn` and
`--device-hbm-peak-gbps` configure device telemetry, the flight
recorder and the timeline (served at /debug/flight and
/debug/timeline).

`--data-dir` makes the store durable (a segmented WAL and columnar
checkpoints, `--wal-fsync`, `--checkpoint-interval`; the dual-write
journal then defaults into `<data-dir>/dtx.sqlite`), and a proxy with a
data dir serves its log to read replicas; `--replicate-from` makes this
proxy such a replica (`--replica-wait-ms`, `--[no-]replica-forward`,
`--replica-user`, `--shed-replica-lag`, `--replica-id`).  The data dir's
format is the reference's, so a deployment moves between `jax://` and
`torch://` on the same volume.  Failover: a replica with
`--promote-data-dir` can be promoted to leader (`POST
/replication/promote`, or by election with `--promote-on-leader-loss`,
`--leader-loss-grace` and `--replica-peers`); a leader given
`--replica-peers` probes them and steps down when a newer incarnation
leads; `--serve-replication` (with `--replication-mirror-dir`) makes a
replica relay the log to further replicas.

Sharding (spicedb/sharding): `--shards N` with `--partition-map
type=shard,...` splits the tuple space by resource type across N
in-process leaders (each with its own graph on the card over
`torch://`, and its own lineage under `<data-dir>/shard-<k>`);
`--shard-leaders URL,...` runs this process as the thin stateless
router in front of N single-shard proxies instead of serving; and
`--lint-schema` (`--lint-schema-strict`, `--lint-schema-json`) lints
the bootstrap schema and the rules instead of serving, the sharding
co-location rules SL007/SL008 included when a partition is configured
(exit 0 clean, 1 findings, 2 inputs that would not boot).

Fleet tracing: every internal hop (router to shard leader, follower to
leader) carries the X-Authz-* propagation headers, so the receiving
proxy joins the caller's trace; `--fleet-peers URL,...` names the
members whose traces, flight recorder, workload and metrics this node
merges at /debug/fleet, and /debug/tail explains where p99 - p50 lives
from that merge.  On the `--shard-leaders` router the shard leaders are
members without being listed.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import ssl
import sys
from dataclasses import dataclass
from typing import Optional
from urllib.parse import urlsplit

from . import __version__
from .config import proxyrule
from .proxy import kubeconfig as kubecfg
from .proxy.authn import (
    Authenticator,
    ClientCertAuthenticator,
    HeaderAuthenticator,
    OIDCAuthenticator,
    RequestHeaderAuthenticator,
    TokenFileAuthenticator)
from .proxy.httpcore import Transport
from .proxy.server import Options as ServerOptions, ProxyServer
from .spicedb.endpoints import Bootstrap

DEFAULT_WORKFLOW_DATABASE_PATH = "/tmp/dtx.sqlite"  # options.go:41
DEFAULT_ENDPOINT = "torch://"
ENDPOINT_SCHEMES = ("torch", "embedded")
REMOTE_SCHEMES = ("grpc", "grpcs", "http", "https")

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch")


def resolve_workflow_db(data_dir: str, workflow_database_path: str) -> str:
    """The SQLite dual-write journal defaults into the persistence data
    dir when one is configured: the journal and the relationship store
    must share a fate for crash recovery to replay pending dual writes
    against the state they committed into."""
    if data_dir and workflow_database_path == DEFAULT_WORKFLOW_DATABASE_PATH:
        import os
        os.makedirs(data_dir, exist_ok=True)
        return os.path.join(data_dir, "dtx.sqlite")
    return workflow_database_path


def _store_backed(endpoint: str) -> bool:
    return urlsplit(endpoint).scheme in ENDPOINT_SCHEMES


def _endpoint_served(endpoint: str) -> bool:
    """A store-backed scheme, a remote one, or a scheme-less `host:port`
    (a remote endpoint, as in the reference, options.go:107)."""
    if endpoint and "://" not in endpoint:
        return True
    return urlsplit(endpoint).scheme in ENDPOINT_SCHEMES + REMOTE_SCHEMES


def _fleet_peers(args) -> list:
    return [u.strip() for u in args.fleet_peers.split(",") if u.strip()]


def _durable_store_on() -> bool:
    from .utils import features
    return features.DURABLE_STORE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spicedb-kubeapi-proxy-tpu-torch",
        description="Authorizes Kube api requests against a relationship "
                    "graph (CUDA-accelerated via the torch:// endpoint).",
        allow_abbrev=False,
    )
    p.add_argument("--version", action="version", version=__version__)

    # SpiceDB endpoint options (reference options.go:106-112)
    p.add_argument("--spicedb-endpoint", default=DEFAULT_ENDPOINT,
                   help="endpoint authorizing proxy operations: torch:// "
                        "(hand-written CUDA kernels on the card; "
                        "torch://?device=cpu runs their plain twins on "
                        "the CPU), embedded:// (in-memory host "
                        "evaluator), or grpc://host:port (a remote "
                        "permissions service such as permsd; needs "
                        "grpcio)")
    p.add_argument("--spicedb-insecure", action="store_true",
                   help="use insecure transport for the remote gRPC endpoint")
    p.add_argument("--spicedb-skip-verify-ca", action="store_true",
                   help="do not verify the remote endpoint's certificate chain")
    p.add_argument("--spicedb-token", default="",
                   help="preshared key for the remote endpoint")
    p.add_argument("--spicedb-ca-path", default="",
                   help="directory or file with CAs to trust for the remote "
                        "endpoint")
    p.add_argument("--spicedb-bootstrap", default="",
                   help="YAML file with bootstrap schema/relationships for "
                        "the endpoint")
    p.add_argument("--decision-cache", action="store_true",
                   help="revision-keyed decision cache with relation-scoped "
                        "invalidation in front of the endpoint: repeated "
                        "identical checks/LookupResources are served from "
                        "cache until a write touches a relation in their "
                        "compiled footprint")
    p.add_argument("--decision-cache-bytes", type=int, default=0,
                   help="decision-cache LRU bound in bytes "
                        "(0 = default 128MiB)")
    # batched dispatch (spicedb/dispatch.py; killswitch:
    # --feature-gates DevicePipeline=false)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="fused dispatch pipeline depth for torch://: "
                        "N-1 started batches stay in flight so batch "
                        "N+1's host encode and kernel launches overlap "
                        "batch N's readback (1 = fully serial)")
    p.add_argument("--prewarm-compiles", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="at warm start, build the kernel library and "
                        "capture every lane bucket's sweep graphs, so "
                        "the first request of each bucket pays none of "
                        "it (torch:// only; on by default)")
    # admission control (utils/admission.py; killswitch:
    # --feature-gates AdmissionControl=false)
    p.add_argument("--max-queue-depth", type=int, default=0,
                   help="bound on each dispatcher queue (checks and "
                        "LookupResources): an enqueue past the bound is "
                        "rejected with 429 + Retry-After instead of "
                        "queueing unboundedly; dual-write authorization "
                        "is exempt (0 = unbounded)")
    p.add_argument("--shed-queue-depth", type=int, default=0,
                   help="load-shed threshold: read-only requests are "
                        "rejected with 429 + Retry-After BEFORE "
                        "authorization work starts once the dispatcher "
                        "queues reach this depth (0 = disabled)")
    p.add_argument("--shed-slo-burn", action="store_true",
                   help="also shed read-only requests while an SLO "
                        "(--slo-check-p99-ms / --slo-error-rate) burns "
                        "on both horizons; update verbs are never shed")
    p.add_argument("--shed-retry-after", type=float, default=1.0,
                   help="Retry-After seconds suggested on shed "
                        "responses")

    # WAL-shipping replication (spicedb/replication; killswitch:
    # --feature-gates Replication=false)
    p.add_argument("--replicate-from", default="",
                   help="run as a read replica of the proxy at this base "
                        "URL (e.g. http://leader:8443): bootstrap from "
                        "its newest checkpoint, tail its WAL segments, "
                        "serve read-only traffic at bounded staleness, "
                        "and forward update verbs to it.  Exclusive "
                        "with --data-dir (the leader owns the log).  "
                        "The leader serves the replication API whenever "
                        "it has a --data-dir")
    p.add_argument("--replica-wait-ms", type=float, default=2000.0,
                   help="how long a replica read carrying "
                        "X-Authz-Min-Revision waits for the tail to "
                        "reach that revision before forwarding to the "
                        "leader (or 503 when forwarding is disabled)")
    p.add_argument("--replica-forward", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="forward update verbs and too-stale ZedToken "
                        "reads to the leader; --no-replica-forward "
                        "rejects them 503 with a Status naming the "
                        "leader instead")
    p.add_argument("--replica-user", default="system:replica",
                   help="identity this follower presents to the leader "
                        "(header authentication; the leader must trust "
                        "the follower's transport path)")
    p.add_argument("--shed-replica-lag", type=float, default=0.0,
                   help="shed read-only requests with 429 + Retry-After "
                        "once this replica is at least this many "
                        "seconds behind its leader (0 = disabled); a "
                        "stale replica sheds before serving stale "
                        "answers")
    # failover (spicedb/replication/failover.py)
    p.add_argument("--serve-replication", action="store_true",
                   help="this replica also serves /replication/* from "
                        "a byte mirror of what it applies, so further "
                        "replicas chain off it (fan-out trees) instead "
                        "of all tailing one leader; requires "
                        "--replicate-from")
    p.add_argument("--replication-mirror-dir", default="",
                   help="directory for the --serve-replication artifact "
                        "mirror (default: a private temp dir)")
    p.add_argument("--promote-data-dir", default="",
                   help="data dir this replica will own if promoted to "
                        "leader (POST /replication/promote or "
                        "--promote-on-leader-loss); its WAL and "
                        "checkpoints are wiped at promotion, only the "
                        "incarnation epoch persists across promotions")
    p.add_argument("--promote-on-leader-loss", action="store_true",
                   help="watchdog: after --leader-loss-grace seconds "
                        "without a successful sync, poll "
                        "--replica-peers and run the election (highest "
                        "adopted revision wins, ties break on the "
                        "smallest --replica-id); the winner promotes "
                        "itself, the losers repoint to it.  Requires "
                        "--promote-data-dir")
    p.add_argument("--leader-loss-grace", type=float, default=5.0,
                   help="seconds without a successful sync before the "
                        "leader-loss watchdog starts an election; keep "
                        "it well under one flight window so failover "
                        "completes inside it")
    p.add_argument("--replica-peers", default="",
                   help="comma-separated base URLs of the other proxies "
                        "of the deployment: election candidates for a "
                        "replica, fence probes for a (possibly "
                        "resurrected) leader")
    p.add_argument("--replica-id", default="",
                   help="stable identity in elections, "
                        "/replication/status and /debug/replication "
                        "(default: minted per process); the election "
                        "tie-break orders on it")
    p.add_argument("--fleet-peers", default="",
                   help="comma-separated base URLs of fleet members "
                        "whose /debug/traces, /debug/flight, "
                        "/debug/workload and /metrics this node merges at "
                        "/debug/fleet (cross-process trace assembly and "
                        "per-tier attribution; /debug/tail explains the "
                        "tail from it).  On the --shard-leaders router the "
                        "shard leaders are included implicitly")

    # tuple-space sharding (spicedb/sharding; killswitch:
    # --feature-gates Sharding=false)
    p.add_argument("--shards", type=int, default=1,
                   help="split the tuple space by resource type across "
                        "this many independent in-process leaders, each "
                        "with its own WAL/checkpoint lineage under "
                        "<data-dir>/shard-<k> and, over torch://, its "
                        "own graph on the card (embedded:// and "
                        "torch:// only; 1 = single leader).  The "
                        "partition is validated against every "
                        "permission's and rule's relation_footprint "
                        "closure at startup: a closure spanning two "
                        "shards is a hard error")
    p.add_argument("--partition-map", default="",
                   help="comma-separated type=shard assignments "
                        "(e.g. pod=0,secret=1); unassigned types land "
                        "on shard 0.  Shared verbatim by the router "
                        "and every shard leader")
    p.add_argument("--shard-leaders", default="",
                   help="router mode: serve as a thin stateless router "
                        "over these comma-separated shard-leader base "
                        "URLs (one per shard, index = shard id).  Each "
                        "leader is an unmodified proxy with its own "
                        "data dir and replication tree; the router "
                        "maps each request to the shard its matched "
                        "rules' types live on, and translates "
                        "revision-vector ZedTokens to per-shard "
                        "components.  Exclusive with serving locally")

    # static schema/rule lint (spicedb/schema_lint.py): analyze instead
    # of serve
    p.add_argument("--lint-schema", action="store_true",
                   help="lint the bootstrap schema (--spicedb-bootstrap; "
                        "the built-in default schema when omitted) and "
                        "the proxy rules (--rule-config) instead of "
                        "serving: flags unreachable relations, "
                        "permissions with empty footprints, and rule "
                        "templates referencing undefined relations.  "
                        "Exit 1 on errors; --lint-schema-strict also "
                        "fails on warnings")
    p.add_argument("--lint-schema-strict", action="store_true",
                   help="with --lint-schema, exit 1 on warnings too")
    p.add_argument("--lint-schema-json", action="store_true",
                   help="with --lint-schema, emit machine-readable JSON; "
                        "same exit-code contract: 0 clean, 1 findings, "
                        "2 inputs would not boot")

    # upstream cluster (options.go:203-206)
    p.add_argument("--backend-kubeconfig", default="",
                   help="path to the kubeconfig for the upstream apiserver; "
                        "should authenticate with cluster-admin permission")
    p.add_argument("--use-in-cluster-config", action="store_true",
                   help="use the ambient service-account config as upstream")
    p.add_argument("--override-upstream", action="store_true", default=True,
                   help="rewrite the kubeconfig server address from the "
                        "KUBERNETES_SERVICE_HOST/PORT environment")
    p.add_argument("--no-override-upstream", dest="override_upstream",
                   action="store_false")

    # rules + workflow (options.go:201-202,207)
    p.add_argument("--rule-config", default="",
                   help="path to the proxy rule configuration (multi-doc YAML)")
    p.add_argument("--workflow-database-path",
                   default=DEFAULT_WORKFLOW_DATABASE_PATH,
                   help="SQLite database backing the dual-write workflow "
                        "engine (defaults into --data-dir/dtx.sqlite when "
                        "a data dir is configured)")

    # durable relationship store (spicedb/persist)
    p.add_argument("--data-dir", default="",
                   help="directory for the durable relationship store "
                        "(segmented WAL + columnar checkpoints); empty = "
                        "in-memory only.  On restart the store is "
                        "recovered from the newest checkpoint plus the "
                        "WAL tail, the revision counter continues, and "
                        "the bootstrap RELATIONSHIPS are skipped "
                        "(bootstrap-once) — keep passing "
                        "--spicedb-bootstrap: its schema is not "
                        "persisted and is required every start")
    p.add_argument("--wal-fsync", default="interval",
                   choices=["always", "interval", "never"],
                   help="WAL fsync policy: always (every committed write "
                        "is durable before it is acked), interval "
                        "(~1s loss window), never (OS cache only)")
    p.add_argument("--checkpoint-interval", type=float, default=300.0,
                   help="seconds between store checkpoints; each "
                        "checkpoint lets covered WAL segments be "
                        "reclaimed and bounds restart replay time")
    p.add_argument("--lock-mode", default=proxyrule.PESSIMISTIC_LOCK_MODE,
                   choices=[proxyrule.PESSIMISTIC_LOCK_MODE,
                            proxyrule.OPTIMISTIC_LOCK_MODE],
                   help="default dual-write locking strategy")

    # serving (SecureServingOptions)
    p.add_argument("--bind-address", default="0.0.0.0")
    p.add_argument("--secure-port", type=int, default=443)
    p.add_argument("--cert-dir", default="apiserver.local.config/certificates",
                   help="directory for the serving certificate pair; a "
                        "self-signed pair is generated if none exists")
    p.add_argument("--tls-cert-file", default="")
    p.add_argument("--tls-private-key-file", default="")
    p.add_argument("--embedded-mode", action="store_true",
                   help="serve plain HTTP with header authentication "
                        "(X-Remote-User/-Group/-Extra-*); for use behind a "
                        "trusted front end or for embedding")

    # authentication (reference authn.go:17-53)
    p.add_argument("--client-ca-file", default="",
                   help="CA bundle for verifying client certificates "
                        "(CN -> user, O -> groups)")
    p.add_argument("--token-auth-file", default="",
                   help="CSV file of static bearer tokens "
                        "(token,user,uid,groups)")
    # front-proxy (request-header) authn (reference authn.go:121-153)
    p.add_argument("--requestheader-client-ca-file", default="",
                   help="CA bundle; X-Remote-* identity headers are "
                        "trusted only from clients whose certificate "
                        "verifies against it")
    p.add_argument("--requestheader-allowed-names", default="",
                   help="comma-separated CNs allowed to front-proxy; "
                        "empty = any CN under the requestheader CA")
    p.add_argument("--requestheader-username-headers",
                   default="X-Remote-User")
    p.add_argument("--requestheader-group-headers",
                   default="X-Remote-Group")
    p.add_argument("--requestheader-extra-headers-prefix",
                   default="X-Remote-Extra-")
    # OIDC bearer authn with static JWKS (no egress for discovery)
    p.add_argument("--oidc-issuer-url", default="")
    p.add_argument("--oidc-client-id", default="")
    p.add_argument("--oidc-jwks-file", default="",
                   help="static JWKS (RFC 7517) file with the issuer's "
                        "signing keys; required with --oidc-issuer-url")
    p.add_argument("--oidc-username-claim", default="sub")
    p.add_argument("--oidc-groups-claim", default="groups")
    p.add_argument("--oidc-username-prefix", default="")

    # observability
    p.add_argument("--trace-slow-threshold", type=float, default=0.0,
                   help="seconds; a request slower than this logs its full "
                        "trace (per-phase span breakdown) as structured "
                        "JSON (0 disables the log; traces always feed the "
                        "phase histograms)")
    p.add_argument("--audit-level", default="Metadata",
                   help="decision-audit level: None (off), Metadata "
                        "(identity + decision), Request (adds relationship "
                        "strings, caveat context, explain witnesses)")
    p.add_argument("--audit-sample-every", type=int, default=1,
                   help="emit 1 of every N ALLOWED decisions per "
                        "(user, verb); denials and errors always pass")
    p.add_argument("--audit-explain", action="store_true",
                   help="attach the relation-path witness to every audited "
                        "denial (otherwise only requests with ?explain=1 "
                        "are explained)")
    # device telemetry: flight recorder and SLO burn rates
    # (utils/devtel.py), and the dispatch timeline (utils/timeline.py)
    p.add_argument("--flight-window", type=float, default=10.0,
                   help="seconds per flight-recorder window; each window "
                        "snapshots phase quantiles, queue depths, the HBM "
                        "ledger, batch occupancy, and SLO burn rates, "
                        "served at /debug/flight")
    p.add_argument("--flight-windows", type=int, default=64,
                   help="flight-recorder ring capacity (windows retained)")
    p.add_argument("--slo-check-p99-ms", type=float, default=0.0,
                   help="latency SLO target in ms: requests slower than "
                        "this consume the error budget set by "
                        "--slo-objective; burn rates export as "
                        "authz_slo_burn_rate{slo=latency_p99} and surface "
                        "in /readyz when burning (0 disables)")
    p.add_argument("--slo-objective", type=float, default=0.01,
                   help="allowed fraction of requests slower than the "
                        "latency SLO target (the error budget; burn rate "
                        "1.0 = consuming it exactly at the sustainable "
                        "rate)")
    p.add_argument("--slo-error-rate", type=float, default=0.0,
                   help="error SLO: allowed fraction of 5xx responses "
                        "(0 disables)")
    p.add_argument("--device-hbm-peak-gbps", type=float, default=0.0,
                   help="the card's memory rate in GB/s for the "
                        "authz_roofline_fraction export and the "
                        "/debug/timeline summary; 0 (default) detects it "
                        "from the card (NVIDIA H100 80GB HBM3 -> 3350)")

    p.add_argument("-v", "--verbosity", type=int, default=3,
                   help="log verbosity (reference defaults to 3)")
    p.add_argument("--feature-gates", default="",
                   help="comma-separated name=true|false overrides of the "
                        "port's switches: MeshExecution, "
                        "CrossRequestBatching, DevicePipeline, "
                        "AdmissionControl, AsyncRebuild, DecisionCache, "
                        "DeviceTelemetry, Timeline, KernelIntrospect, "
                        "Profiler, DurableStore, Replication, Sharding, "
                        "TailExplain (utils/features.py)")
    return p


@dataclass
class CompletedConfig:
    server_options: ServerOptions
    bind_address: str
    secure_port: int
    embedded_mode: bool


class OptionsError(ValueError):
    pass


def validate(args: argparse.Namespace) -> list:
    """Mirror of Options.Validate (reference options.go:412-427)."""
    errs = []
    if args.lint_schema:
        # analysis mode: no upstream, no serving — only the schema/rule
        # inputs matter
        return []
    from .spicedb.sharding import PartitionMap, PartitionMapError
    if args.shard_leaders:
        # router mode: no upstream, no local endpoint — the shard
        # leaders do the serving
        urls = [u.strip() for u in args.shard_leaders.split(",")
                if u.strip()]
        for u in urls:
            if not u.startswith(("http://", "https://")):
                errs.append(f"--shard-leaders entry {u!r} must be an "
                            f"http(s) base URL")
        if args.shards > 1:
            errs.append("--shards describes in-process sharding; router "
                        "mode derives the shard count from the "
                        "--shard-leaders list")
        if args.replicate_from:
            errs.append("--shard-leaders (router mode) is exclusive "
                        "with --replicate-from")
        if args.data_dir:
            errs.append("--shard-leaders (router mode) is exclusive "
                        "with --data-dir: the router is stateless; the "
                        "shard leaders own the logs")
        if urls and not errs:
            try:
                PartitionMap.parse(args.partition_map,
                                   n_shards=len(urls))
            except PartitionMapError as e:
                errs.append(f"--partition-map: {e}")
        if not args.embedded_mode and not (0 < args.secure_port < 65536):
            errs.append(f"--secure-port {args.secure_port} is not a "
                        f"valid port")
        return errs
    if not _endpoint_served(args.spicedb_endpoint):
        errs.append(f"--spicedb-endpoint {args.spicedb_endpoint!r} is not "
                    f"served here: use torch:// (the CUDA card; "
                    f"torch://?device=cpu for the CPU), embedded:// or a "
                    f"remote grpc://host:port")
    if args.shards < 1:
        errs.append("--shards must be >= 1")
    elif args.shards > 1:
        if not _store_backed(args.spicedb_endpoint):
            errs.append("--shards requires a store-backed endpoint "
                        "(embedded:// or torch://)")
        if args.replicate_from:
            errs.append("--shards is exclusive with --replicate-from: "
                        "a follower tails ONE leader's log; run one "
                        "follower per shard leader instead")
        try:
            PartitionMap.parse(args.partition_map, n_shards=args.shards)
        except PartitionMapError as e:
            errs.append(f"--partition-map: {e}")
    elif args.partition_map:
        try:
            PartitionMap.parse(args.partition_map)
        except PartitionMapError as e:
            errs.append(f"--partition-map: {e}")
    if not args.backend_kubeconfig and not args.use_in_cluster_config:
        errs.append("either --backend-kubeconfig or --use-in-cluster-config"
                    " must be specified")
    if not args.rule_config:
        errs.append("--rule-config is required")
    if not args.embedded_mode and not (0 < args.secure_port < 65536):
        errs.append(f"--secure-port {args.secure_port} is not a valid port")
    if args.trace_slow_threshold < 0:
        errs.append("--trace-slow-threshold must be >= 0")
    from .utils.audit import parse_level
    try:
        parse_level(args.audit_level)
    except ValueError as e:
        errs.append(f"--audit-level: {e}")
    if args.audit_sample_every < 1:
        errs.append("--audit-sample-every must be >= 1")
    if args.pipeline_depth < 1:
        errs.append("--pipeline-depth must be >= 1 (1 = fully serial)")
    if args.max_queue_depth < 0:
        errs.append("--max-queue-depth must be >= 0 (0 = unbounded)")
    if args.shed_queue_depth < 0:
        errs.append("--shed-queue-depth must be >= 0 (0 = disabled)")
    if args.shed_retry_after <= 0:
        errs.append("--shed-retry-after must be > 0")
    if args.decision_cache and not _store_backed(args.spicedb_endpoint):
        errs.append("--decision-cache requires a store-backed endpoint "
                    "(embedded:// or torch://)")
    if args.decision_cache_bytes < 0:
        errs.append("--decision-cache-bytes must be >= 0")
    if args.data_dir and not _store_backed(args.spicedb_endpoint):
        errs.append("--data-dir persistence requires a store-backed "
                    "endpoint (embedded:// or torch://)")
    if args.checkpoint_interval <= 0:
        errs.append("--checkpoint-interval must be > 0")
    if args.flight_window <= 0:
        errs.append("--flight-window must be > 0")
    if args.flight_windows < 2:
        errs.append("--flight-windows must be >= 2 (burn rates need a "
                    "short and a long horizon)")
    if args.slo_check_p99_ms < 0:
        errs.append("--slo-check-p99-ms must be >= 0")
    if not (0 < args.slo_objective <= 1):
        errs.append("--slo-objective must be in (0, 1]")
    if not (0 <= args.slo_error_rate <= 1):
        errs.append("--slo-error-rate must be in [0, 1]")
    if args.device_hbm_peak_gbps < 0:
        errs.append("--device-hbm-peak-gbps must be >= 0 (0 = auto)")
    if args.shed_slo_burn and not (args.slo_check_p99_ms > 0
                                   or args.slo_error_rate > 0):
        errs.append("--shed-slo-burn needs an SLO configured "
                    "(--slo-check-p99-ms or --slo-error-rate)")
    if args.replicate_from:
        if not _store_backed(args.spicedb_endpoint):
            errs.append("--replicate-from requires a store-backed "
                        "endpoint (embedded:// or torch://)")
        if args.data_dir:
            errs.append("--replicate-from is exclusive with --data-dir: "
                        "a follower re-bootstraps from its leader and "
                        "must not journal the leader's log as its own")
        if not args.replicate_from.startswith(("http://", "https://")):
            errs.append("--replicate-from must be an http(s) base URL")
    if args.replica_wait_ms < 0:
        errs.append("--replica-wait-ms must be >= 0")
    if args.serve_replication and not args.replicate_from:
        errs.append("--serve-replication only applies to a replica "
                    "(--replicate-from); a leader always serves "
                    "/replication/* with a --data-dir")
    if args.promote_on_leader_loss and not args.replicate_from:
        errs.append("--promote-on-leader-loss only applies to a replica "
                    "(--replicate-from)")
    if args.promote_on_leader_loss and not args.promote_data_dir:
        errs.append("--promote-on-leader-loss needs --promote-data-dir "
                    "(the data dir a promoted leader will own)")
    if args.promote_data_dir and not args.replicate_from:
        errs.append("--promote-data-dir only applies to a replica "
                    "(--replicate-from)")
    if args.leader_loss_grace <= 0:
        errs.append("--leader-loss-grace must be > 0")
    for peer in (u.strip() for u in args.replica_peers.split(",")):
        if peer and not peer.startswith(("http://", "https://")):
            errs.append(f"--replica-peers entry {peer!r} must be an "
                        f"http(s) base URL")
    for peer in _fleet_peers(args):
        if not peer.startswith(("http://", "https://")):
            errs.append(f"--fleet-peers entry {peer!r} must be an "
                        f"http(s) base URL")
    if args.shed_replica_lag < 0:
        errs.append("--shed-replica-lag must be >= 0 (0 = disabled)")
    if args.shed_replica_lag > 0 and not args.replicate_from:
        errs.append("--shed-replica-lag only applies to a replica "
                    "(--replicate-from)")
    return errs


def complete(args: argparse.Namespace,
             upstream_transport: Optional[Transport] = None) -> CompletedConfig:
    """Mirror of Options.Complete (reference options.go:213-380): logging,
    upstream transport, rules, serving certs, authenticators, endpoint."""
    level = (logging.DEBUG if args.verbosity >= 4
             else logging.INFO if args.verbosity >= 2 else logging.WARNING)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")

    if args.feature_gates:
        from .utils import features
        try:
            features.apply_flag(args.feature_gates)
        except features.FeatureGateError as e:
            raise OptionsError(f"invalid --feature-gates: {e}") from e

    rule_configs: list = []
    if args.rule_config:
        try:
            with open(args.rule_config, "r", encoding="utf-8") as f:
                rules_yaml = f.read()
        except OSError as e:
            raise OptionsError(f"couldn't load rule config: {e}") from e
        try:
            rule_configs = proxyrule.parse(rules_yaml)
        except Exception as e:
            raise OptionsError(f"invalid rule config: {e}") from e

    if upstream_transport is None:
        if args.use_in_cluster_config:
            ctx = kubecfg.in_cluster_context()
        elif args.backend_kubeconfig:
            try:
                ctx = kubecfg.load_kubeconfig(
                    args.backend_kubeconfig,
                    override_upstream=args.override_upstream)
            except OSError as e:
                raise OptionsError(
                    f"couldn't load kubeconfig from path: {e}") from e
        else:
            raise OptionsError("no upstream configured")
        upstream_transport = kubecfg.transport_for(ctx)

    bootstrap = None
    if args.spicedb_bootstrap:
        try:
            bootstrap = Bootstrap.from_file(args.spicedb_bootstrap)
        except (OSError, ValueError) as e:
            raise OptionsError(f"couldn't load spicedb bootstrap: {e}") from e

    ssl_context: Optional[ssl.SSLContext] = None
    authenticators: list[Authenticator] = []
    if args.embedded_mode:
        authenticators.append(HeaderAuthenticator())
    else:
        cert_file, key_file = args.tls_cert_file, args.tls_private_key_file
        if bool(cert_file) != bool(key_file):
            raise OptionsError(
                "--tls-cert-file and --tls-private-key-file must be"
                " specified together")
        if not cert_file:
            cert_file, key_file = kubecfg.generate_self_signed_cert(
                args.cert_dir, hosts=[args.bind_address])
        ssl_context = kubecfg.serving_ssl_context(
            cert_file, key_file, client_ca_file=args.client_ca_file,
            extra_client_ca_files=(args.requestheader_client_ca_file,))
        if args.requestheader_client_ca_file:
            # requestheader outranks plain client-cert authn, matching the
            # k8s union authenticator's order
            try:
                authenticators.append(RequestHeaderAuthenticator(
                    args.requestheader_client_ca_file,
                    allowed_names=tuple(
                        n for n in
                        args.requestheader_allowed_names.split(",") if n),
                    username_headers=tuple(
                        args.requestheader_username_headers.split(",")),
                    group_headers=tuple(
                        args.requestheader_group_headers.split(",")),
                    extra_prefixes=tuple(
                        args.requestheader_extra_headers_prefix.split(","))))
            except (OSError, ValueError) as e:
                raise OptionsError(
                    f"couldn't load requestheader CA: {e}") from e
        if args.client_ca_file:
            authenticators.append(ClientCertAuthenticator())
    if args.oidc_issuer_url:
        if not args.oidc_jwks_file:
            raise OptionsError(
                "--oidc-jwks-file is required with --oidc-issuer-url "
                "(no egress for issuer discovery)")
        try:
            authenticators.append(OIDCAuthenticator(
                args.oidc_issuer_url, args.oidc_client_id,
                args.oidc_jwks_file,
                username_claim=args.oidc_username_claim,
                groups_claim=args.oidc_groups_claim,
                username_prefix=args.oidc_username_prefix))
        except (OSError, ValueError) as e:
            raise OptionsError(f"couldn't load OIDC JWKS: {e}") from e
    if args.token_auth_file:
        try:
            authenticators.append(TokenFileAuthenticator(args.token_auth_file))
        except OSError as e:
            raise OptionsError(f"couldn't load token auth file: {e}") from e
    if not authenticators:
        # serving mode with no explicit authn: accept client certs if the
        # handshake produced one (self-signed default trusts none)
        authenticators.append(ClientCertAuthenticator())

    # the dispatcher's pipeline depth and queue bound; a URL parameter
    # (`torch://?pipeline_depth=N`) still overrides inside create_endpoint
    endpoint_kwargs = {"pipeline_depth": args.pipeline_depth,
                       "max_queue_depth": args.max_queue_depth}
    if args.decision_cache:
        endpoint_kwargs["decision_cache"] = True
    if args.decision_cache_bytes:
        # independent of --decision-cache: the cache may come up through
        # `?cache=1` or the DecisionCache gate, and the bound applies then
        endpoint_kwargs["decision_cache_bytes"] = args.decision_cache_bytes
    if not _store_backed(args.spicedb_endpoint):
        # every other endpoint dials gRPC, the scheme-less `host:port`
        # included (reference options.go:107), and carries the
        # connection flags
        endpoint_kwargs = {
            "token": args.spicedb_token,
            "insecure": args.spicedb_insecure,
            "skip_verify_ca": args.spicedb_skip_verify_ca,
            "ca_path": args.spicedb_ca_path,
        }

    server_options = ServerOptions(
        spicedb_endpoint=args.spicedb_endpoint,
        bootstrap=bootstrap,
        rule_configs=rule_configs,
        upstream_transport=upstream_transport,
        authenticators=authenticators,
        # the journal relocates into the data dir only when persistence
        # will actually engage: with the DurableStore switch off the
        # store runs in memory, and the journal must not imply a shared
        # fate that does not exist
        workflow_database_path=resolve_workflow_db(
            args.data_dir if _durable_store_on() else "",
            args.workflow_database_path),
        lock_mode_default=args.lock_mode,
        ssl_context=ssl_context,
        endpoint_kwargs=endpoint_kwargs,
        trace_slow_threshold=args.trace_slow_threshold,
        audit_level=args.audit_level,
        audit_sample_every=args.audit_sample_every,
        audit_explain=args.audit_explain,
        prewarm_compiles=args.prewarm_compiles,
        shed_queue_depth=args.shed_queue_depth,
        shed_slo_burn=args.shed_slo_burn,
        shed_retry_after_s=args.shed_retry_after,
        flight_window_s=args.flight_window,
        flight_windows=args.flight_windows,
        slo_check_p99_ms=args.slo_check_p99_ms,
        slo_objective=args.slo_objective,
        slo_error_rate=args.slo_error_rate,
        device_hbm_peak_gbps=args.device_hbm_peak_gbps,
        data_dir=args.data_dir,
        wal_fsync=args.wal_fsync,
        checkpoint_interval=args.checkpoint_interval,
        replicate_from=args.replicate_from,
        replica_wait_ms=args.replica_wait_ms,
        replica_forward=args.replica_forward,
        replica_user=args.replica_user,
        shed_replica_lag_s=args.shed_replica_lag,
        serve_replication=args.serve_replication,
        mirror_dir=args.replication_mirror_dir,
        promote_data_dir=args.promote_data_dir,
        promote_on_leader_loss=args.promote_on_leader_loss,
        leader_loss_grace_s=args.leader_loss_grace,
        replica_peers=[u.strip() for u in args.replica_peers.split(",")
                       if u.strip()],
        replica_id=args.replica_id,
        shards=args.shards,
        partition_map=args.partition_map,
        fleet_peers=_fleet_peers(args),
    )
    return CompletedConfig(server_options=server_options,
                           bind_address=args.bind_address,
                           secure_port=args.secure_port,
                           embedded_mode=args.embedded_mode)


def endpoint_device(endpoint) -> str:
    """What the endpoint computes on: the card's name for a `torch://`
    endpoint on CUDA, `remote <target>` for a gRPC endpoint, else `cpu`
    (the twins, or the host evaluator)."""
    ep = endpoint
    while ep is not None and getattr(ep, "device", None) is None:
        if getattr(ep, "target", None) is not None:
            return f"remote {ep.target}"
        ep = getattr(ep, "inner", None)
    device = getattr(ep, "device", None)
    if device is None or device.type != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(device)


async def run_server(completed: CompletedConfig) -> None:
    """Server.Run equivalent (reference server.go:170-208): serve until
    SIGINT/SIGTERM."""
    server = ProxyServer(completed.server_options)
    server.enable_dual_writes()
    port = await server.start(completed.bind_address, completed.secure_port)
    scheme = "http" if completed.embedded_mode else "https"
    logger.info("serving on %s://%s:%d; endpoint %s on %s", scheme,
                completed.bind_address, port,
                completed.server_options.spicedb_endpoint,
                endpoint_device(server.endpoint))

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix
            pass
    try:
        await stop.wait()
    finally:
        await server.stop()


def _normalize_argv(argv: list) -> list:
    """pflag word-separator normalization (reference main.go:23): underscores
    in flag names are equivalent to dashes."""
    out = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            name, _, val = a.partition("=")
            out.append(name.replace("_", "-") + "=" + val)
        elif a.startswith("--"):
            out.append(a.replace("_", "-"))
        else:
            out.append(a)
    return out


def run_schema_lint(args: argparse.Namespace) -> int:
    """`--lint-schema`: static schema/rule analysis
    (spicedb/schema_lint.py) instead of serving.  Exit 0 = clean (or
    warnings only, unless --lint-schema-strict), 1 = findings, 2 = the
    inputs would not even boot."""
    from .spicedb import schema as sch
    from .spicedb import schema_lint
    from .spicedb.endpoints import (
        DEFAULT_BOOTSTRAP_SCHEMA,
        merge_internal_definitions,
    )

    try:
        schema_text = DEFAULT_BOOTSTRAP_SCHEMA
        if args.spicedb_bootstrap:
            bootstrap = Bootstrap.from_file(args.spicedb_bootstrap)
            if bootstrap.schema_text:
                schema_text = bootstrap.schema_text
        schema = merge_internal_definitions(sch.parse_schema(schema_text))
        rule_configs = (proxyrule.parse_file(args.rule_config)
                        if args.rule_config else [])
        # sharding co-location lint (SL007/SL008) engages when a
        # partition is configured: --shards N and/or an explicit
        # --partition-map (router mode infers the count from the
        # leader list)
        partition_map = None
        if args.partition_map or args.shards > 1 or args.shard_leaders:
            from .spicedb.sharding import PartitionMap
            n_shards = None
            if args.shard_leaders:
                n_shards = len([u for u in args.shard_leaders.split(",")
                                if u.strip()])
            elif args.shards > 1:
                n_shards = args.shards
            partition_map = PartitionMap.parse(args.partition_map,
                                               n_shards=n_shards)
    except Exception as e:
        if args.lint_schema_json:
            print(json.dumps({"version": 1, "error": str(e),
                              "findings": []}))
        print(f"error: {e}", file=sys.stderr)
        return 2
    findings = schema_lint.lint_schema(schema, rule_configs,
                                       partition_map=partition_map)
    errors = [f for f in findings if f.severity == "error"]
    warnings = [f for f in findings if f.severity != "error"]
    failed = bool(errors or (warnings and args.lint_schema_strict))
    if args.lint_schema_json:
        # the reference's shape and exit-code contract (0 clean, 1
        # findings, 2 boot failure)
        print(json.dumps({
            "version": 1,
            "findings": [{"code": f.code, "severity": f.severity,
                          "where": f.where, "message": f.message}
                         for f in findings],
            "summary": {"errors": len(errors), "warnings": len(warnings),
                        "strict": bool(args.lint_schema_strict)},
        }, indent=1))
    else:
        for f in findings:
            print(f"{f.severity.upper()} {f.code} [{f.where}] {f.message}")
        print(f"schema lint: {len(errors)} errors, "
              f"{len(warnings)} warnings")
    return 1 if failed else 0


def run_router(args: argparse.Namespace) -> int:
    """`--shard-leaders`: serve as the thin stateless shard router
    (spicedb/sharding/router.py) instead of a local proxy.  The routing
    table derives from --rule-config (+ the bootstrap schema's
    footprint closures when supplied) and is validated at startup: a
    rule whose types span shards refuses to boot."""
    level = (logging.DEBUG if args.verbosity >= 4
             else logging.INFO if args.verbosity >= 2 else logging.WARNING)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    if args.feature_gates:
        from .utils import features
        try:
            features.apply_flag(args.feature_gates)
        except features.FeatureGateError as e:
            print(f"error: invalid --feature-gates: {e}", file=sys.stderr)
            return 1
    from .spicedb import schema as sch
    from .spicedb import sharding
    from .spicedb.endpoints import merge_internal_definitions
    try:
        import yaml
        config_errors = (OSError, ValueError, yaml.YAMLError)
    except ImportError:  # the bootstrap and rule files then fail to load
        config_errors = (OSError, ValueError, ImportError)
    urls = [u.strip() for u in args.shard_leaders.split(",") if u.strip()]
    try:
        pmap = sharding.PartitionMap.parse(args.partition_map,
                                           n_shards=len(urls))
        rule_configs = (proxyrule.parse_file(args.rule_config)
                        if args.rule_config else [])
        schema = None
        if args.spicedb_bootstrap:
            bootstrap = Bootstrap.from_file(args.spicedb_bootstrap)
            if bootstrap.schema_text:
                schema = merge_internal_definitions(
                    sch.parse_schema(bootstrap.schema_text))
        ssl_context: Optional[ssl.SSLContext] = None
        if not args.embedded_mode:
            cert_file, key_file = args.tls_cert_file, args.tls_private_key_file
            if bool(cert_file) != bool(key_file):
                raise OptionsError(
                    "--tls-cert-file and --tls-private-key-file must be"
                    " specified together")
            if not cert_file:
                cert_file, key_file = kubecfg.generate_self_signed_cert(
                    args.cert_dir, hosts=[args.bind_address])
            ssl_context = kubecfg.serving_ssl_context(cert_file, key_file)
        server = sharding.RouterServer(
            pmap, urls, rule_configs=rule_configs, schema=schema,
            ssl_context=ssl_context, fleet_peers=_fleet_peers(args))
    except config_errors as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not sharding.enabled():
        logger.info("Sharding switch off: routing everything to shard "
                    "%d (pass-through)", pmap.default_shard)

    async def serve() -> None:
        port = await server.start(args.bind_address, args.secure_port)
        scheme = "http" if args.embedded_mode else "https"
        logger.info("shard router serving on %s://%s:%d over %d shard "
                    "leader(s): %s", scheme, args.bind_address, port,
                    len(urls), ", ".join(urls))
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # non-unix
                pass
        try:
            await stop.wait()
        finally:
            await server.stop()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(_normalize_argv(
        list(sys.argv[1:] if argv is None else argv)))
    errs = validate(args)
    if errs:
        for e in errs:
            print(f"error: {e}", file=sys.stderr)
        return 2
    if args.lint_schema:
        return run_schema_lint(args)
    if args.shard_leaders:
        return run_router(args)
    try:
        completed = complete(args)
    except OptionsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        asyncio.run(run_server(completed))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
