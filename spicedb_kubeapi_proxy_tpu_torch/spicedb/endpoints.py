"""Endpoint plugin boundary: `embedded://` | `torch://` | `grpc://`.

Mirrors the reference's SpiceDB-endpoint dispatch on URL scheme
(reference pkg/proxy/options.go:307-369): upper layers speak only this
interface and never know which backend ran.

- `embedded://`  host tuple store + recursive evaluator (the oracle);
                 replaces the reference's in-process SpiceDB
                 (pkg/spicedb/spicedb.go:18-71)
- `torch://`     same store, but check/LookupResources execute as a
                 bit-packed fixpoint sweep of hand-written CUDA kernels
                 (ops/torch_endpoint.py); `torch://?device=cpu` runs the
                 kernels' plain-torch twins instead
- `grpc://host:port` a remote permissions service over gRPC
                 (spicedb/grpc_remote.py; needs grpcio, imported when
                 the channel is dialed), e.g. a `permsd` serving
                 `torch://` on a card for many proxies

Either store-backed scheme may sit behind the decision cache
(`?cache=1`).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Any, Iterable, Optional
from urllib.parse import parse_qs, urlsplit

from . import schema as sch
from .evaluator import Evaluator
from .store import TupleStore, Watcher
from .types import (
    AnnotatedIds,
    CheckRequest,
    CheckResult,
    Permissionship,
    Precondition,
    RelationshipFilter,
    RelationshipUpdate,
    SchemaError,
    SubjectRef,
    parse_relationship,
)

logger = logging.getLogger("spicedb_kubeapi_proxy_tpu_torch.spicedb")


def apply_bootstrap_once(store: TupleStore, rel_text: str) -> bool:
    """Bootstrap-once semantics shared by the store-backed endpoints:
    `--spicedb-bootstrap` relationships apply only to a store with no
    history (revision 0).  A store recovered from a data dir
    (spicedb/persist) carries a revision > 0, so a restart never
    double-applies bootstrap writes on top of recovered state."""
    if not rel_text.strip():
        return False
    if store.revision > 0:
        logger.info(
            "skipping bootstrap relationships: store already carries "
            "state at revision %d (recovered from a data dir)",
            store.revision)
        return False
    store.bulk_load_text(rel_text)
    return True


class PermissionsEndpoint:
    """The endpoint contract (PermissionsService + WatchService subset)."""

    def _validate_updates(self, updates: Iterable[RelationshipUpdate]) -> list:
        """Schema-validate writes (SpiceDB WriteRelationships semantics)
        for any endpoint that carries a schema; shared by the embedded and
        torch backends so the rule set cannot diverge."""
        updates = list(updates)
        schema = getattr(self, "schema", None)
        if schema is not None:
            for u in updates:
                sch.validate_relationship(schema, u.rel)
        return updates

    async def check_permission(self, req: CheckRequest) -> CheckResult:
        raise NotImplementedError

    async def check_bulk_permissions(self, reqs: list) -> list:
        raise NotImplementedError

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject: SubjectRef) -> list:
        raise NotImplementedError

    async def lookup_resources_batch(self, resource_type: str, permission: str,
                                     subjects: list) -> list:
        """One allowed-id list per subject.  Backends that can batch
        (torch://) fuse the whole batch into a single kernel invocation."""
        return [await self.lookup_resources(resource_type, permission, s)
                for s in subjects]

    async def lookup_resources_stream(self, resource_type: str,
                                      permission: str, subject: SubjectRef):
        """Async iterator of allowed resource ids (the reference drains
        the LookupResources server-stream incrementally, lookups.go:74-135).
        Default: wrap the materialized list; `torch://` yields chunks."""
        for rid in await self.lookup_resources(resource_type, permission,
                                               subject):
            yield rid

    async def read_relationships(self, flt: RelationshipFilter) -> list:
        raise NotImplementedError

    async def read_relationships_stream(self, flt: RelationshipFilter):
        """Async iterator of relationships (reference activity.go:160-172
        drains a server-stream).  Default wraps the materialized list."""
        for rel in await self.read_relationships(flt):
            yield rel

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()) -> int:
        raise NotImplementedError

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()) -> int:
        raise NotImplementedError

    def watch(self, object_types: Optional[Iterable[str]] = None) -> Watcher:
        raise NotImplementedError

    async def close(self) -> None:
        pass


@dataclass
class Bootstrap:
    schema_text: str = ""
    relationships_text: str = ""

    @classmethod
    def from_mapping(cls, data: dict) -> "Bootstrap":
        return cls(schema_text=data.get("schema", "") or "",
                   relationships_text=data.get("relationships", "") or "")

    @classmethod
    def from_yaml(cls, content: str) -> "Bootstrap":
        import yaml  # lazy: only YAML bootstraps need it
        data = yaml.safe_load(content) or {}
        if not isinstance(data, dict):
            raise ValueError("bootstrap content must be a YAML mapping")
        return cls.from_mapping(data)

    @classmethod
    def from_file(cls, path: str) -> "Bootstrap":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_yaml(f.read())

    def relationships(self) -> list:
        rels = []
        for line in self.relationships_text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rels.append(parse_relationship(line))
        return rels


# The proxy's own definitions (dual-write locks, workflow idempotency keys)
# are merged into every user-supplied bootstrap schema — the reference
# always loads its embedded bootstrap.yaml into embedded SpiceDB alongside
# user content (spicedb.go:63-67), so lock/workflow tuples validate there
# regardless of the user's schema.
INTERNAL_SCHEMA = """
use expiration

definition lock {
  relation workflow: workflow
}

definition workflow {
  relation idempotency_key: activity with expiration
}

definition activity {}
"""

# The default bootstrap schema applied when none is supplied: the proxy's own
# workflow/lock/idempotency definitions plus the demo cluster/namespace/pod
# types (behavioral equivalent of the reference's embedded bootstrap.yaml).
DEFAULT_BOOTSTRAP_SCHEMA = INTERNAL_SCHEMA + """
definition cluster {}
definition user {}
definition namespace {
  relation cluster: cluster
  relation creator: user
  relation viewer: user

  permission admin = creator
  permission edit = creator
  permission view = viewer + creator
  permission no_one_at_all = nil
}
definition pod {
  relation namespace: namespace
  relation creator: user
  relation viewer: user
  permission edit = creator
  permission view = viewer + creator
}
definition testresource {
  relation namespace: namespace
  relation creator: user
  relation viewer: user
  permission edit = creator
  permission view = viewer + creator
}
"""


def merge_internal_definitions(schema: "sch.Schema") -> "sch.Schema":
    """Add the proxy-internal definitions to `schema`.  A user definition
    reusing one of the internal type names must carry the relations the
    dual-write engine writes — otherwise every update rule would fail at
    runtime once write validation runs — so collisions that drop an
    internal relation are a loud bootstrap error, not a silent shadow."""
    internal = sch.parse_schema(INTERNAL_SCHEMA)
    for name, d in internal.definitions.items():
        existing = schema.definitions.get(name)
        if existing is None:
            schema.definitions[name] = d
            continue
        # the user's redefinition must accept every subject-type annotation
        # the engine writes (same relation name is not enough: `relation
        # workflow: user` would still reject lock tuples at runtime)
        missing = [
            f"{rel}: {ref.type}"
            for rel, refs in d.relations.items()
            for ref in refs
            if ref not in (existing.relations.get(rel) or ())
        ]
        if missing:
            raise SchemaError(
                f"definition `{name}` is reserved for the proxy's dual-write "
                f"engine; a bootstrap schema may redefine it only if it "
                f"keeps the engine's relation annotations (missing: "
                f"{missing})")
    if "expiration" not in schema.uses:
        schema.uses = tuple(schema.uses) + ("expiration",)
    return schema


class EmbeddedEndpoint(PermissionsEndpoint):
    """Host tuple store + recursive evaluator (`embedded://`)."""

    def __init__(self, schema: sch.Schema, store: Optional[TupleStore] = None):
        self.schema = schema
        self.store = store if store is not None else TupleStore()
        self.evaluator = Evaluator(schema, self.store)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_bootstrap(cls, bootstrap: Optional[Bootstrap] = None,
                       store: Optional[TupleStore] = None) -> "EmbeddedEndpoint":
        if bootstrap is None or not bootstrap.schema_text:
            schema_text = DEFAULT_BOOTSTRAP_SCHEMA
            rel_text = bootstrap.relationships_text if bootstrap else ""
        else:
            schema_text = bootstrap.schema_text
            rel_text = bootstrap.relationships_text
        endpoint = cls(merge_internal_definitions(sch.parse_schema(schema_text)),
                       store=store)
        apply_bootstrap_once(endpoint.store, rel_text)
        return endpoint

    # -- verbs --------------------------------------------------------------

    _TRISTATE = {0: Permissionship.NO_PERMISSION,
                 1: Permissionship.CONDITIONAL_PERMISSION,
                 2: Permissionship.HAS_PERMISSION}

    def _check_sync(self, req: CheckRequest) -> CheckResult:
        # evaluation + the checked_at revision read are ONE atomic unit
        # under the store lock (reentrant, so the bulk wrapper's outer
        # hold still gives one revision per bulk): writes commit from
        # executor threads now, and an unlocked revision read could
        # stamp a verdict with a revision the evaluation never saw —
        # a replica honoring that ZedToken would serve it as fresh
        with self.store.lock:
            value = self.evaluator.check3(req.resource, req.permission,
                                          req.subject)
            return CheckResult(
                permissionship=self._TRISTATE[value],
                checked_at=self.store.revision,
                source="oracle",
            )

    def _check_bulk_sync(self, reqs: list) -> list:
        # one revision per bulk: writes commit from executor threads
        # (see write_relationships below), so the bulk snapshots under
        # the store lock — the same no-torn-bulk contract the torch
        # endpoint keeps with its capture lock
        with self.store.lock:
            return [self._check_sync(r) for r in reqs]

    def _lookup_sync(self, resource_type: str, permission: str,
                     subject: SubjectRef) -> list:
        # the oracle lookup enumerates candidates and checks each; a
        # write landing mid-enumeration would yield a result correct at
        # NO single revision — hold the lock for the whole pass (the
        # pre-executor behavior, where loop serialization implied it)
        with self.store.lock:
            return self.evaluator.lookup_resources(resource_type,
                                                   permission, subject)

    # Store-touching verbs hop to an executor: the evaluator's reads
    # contend on the store lock, which a concurrent committing writer
    # holds ACROSS the WAL append + fsync — a loop-side acquire would
    # park the whole loop for that disk barrier (analyzer A001 class).

    async def check_permission(self, req: CheckRequest) -> CheckResult:
        return await asyncio.get_running_loop().run_in_executor(
            None, self._check_sync, req)

    async def check_bulk_permissions(self, reqs: list) -> list:
        return await asyncio.get_running_loop().run_in_executor(
            None, self._check_bulk_sync, reqs)

    async def lookup_resources(self, resource_type: str, permission: str,
                               subject: SubjectRef) -> list:
        ids = await asyncio.get_running_loop().run_in_executor(
            None, self._lookup_sync, resource_type, permission, subject)
        return AnnotatedIds(ids, source="oracle")

    async def read_relationships(self, flt: RelationshipFilter) -> list:
        return await asyncio.get_running_loop().run_in_executor(
            None, self.store.read, flt)

    async def write_relationships(self, updates: Iterable[RelationshipUpdate],
                                  preconditions: Iterable[Precondition] = ()) -> int:
        # the commit path journals synchronously (WAL append + fsync
        # under the durable store's policy) before becoming visible —
        # a disk barrier that must never park the event loop (analyzer
        # A001 class); the store lock serializes against every reader,
        # so the hop changes where the write blocks, not what it means
        ups = self._validate_updates(updates)
        pres = list(preconditions)
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.store.write(ups, pres))

    async def delete_relationships(self, flt: RelationshipFilter,
                                   preconditions: Iterable[Precondition] = ()) -> int:
        pres = list(preconditions)
        rev, _ = await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.store.delete_by_filter(flt, pres))
        return rev

    def watch(self, object_types: Optional[Iterable[str]] = None) -> Watcher:
        return self.store.subscribe(object_types)


class EndpointConfigError(ValueError):
    pass


def create_endpoint(url: str,
                    bootstrap: Optional[Bootstrap] = None,
                    **kwargs: Any) -> PermissionsEndpoint:
    """Endpoint registry dispatching on URL scheme
    (reference options.go:307-369).  `torch://` runs on the CUDA device
    unless `torch://?device=cpu` or `device="cpu"` asks for the CPU; a
    missing CUDA device raises instead of falling back.  `kernel=ell|
    segment` (URL or keyword) picks the graph kind, as `TorchEndpoint`'s
    `kernel` argument does.

    `torch://?mesh=auto|DxG` shards the ELL graph over a (data x graph)
    mesh, as `jax://?mesh=` does (reference endpoints.py:464-501): `auto`
    splits every visible card and builds no mesh when one is visible;
    `DxG` takes the first D*G cards and is a configuration error when
    fewer are visible.  With `device=cpu` the D*G shards are co-located
    on the CPU (the counterpart of the reference's virtual CPU devices);
    `auto` there builds no mesh.  Under the MeshExecution gate off, `auto`
    builds no mesh and `DxG` is a configuration error.

    `torch://?distributed=1|auto` joins a `torch.distributed` process
    group first (parallel/distributed.py, `jax://?distributed=`'s
    contract), and `mesh=` then spans every rank: shard (d, g) is placed
    row by row over the ranks, each rank holding its shards on its own
    card.  Every rank must be fed the same requests in the same order
    (SPMD, as the reference's processes are).  What would let two ranks
    run different collectives is refused there, default or not: the
    Leopard index (TorchEndpoint), the batching dispatcher (pass
    `dispatch=direct`) and the decision cache.

    `torch://` is wrapped in the cross-request dispatcher
    (spicedb/dispatch.py `BatchingEndpoint`) unless `dispatch=direct` is
    given or the CROSS_REQUEST_BATCHING switch is off, as `jax://` is
    (reference endpoints.py:507-537).  `max_batch` (default 4096),
    `pipeline_depth` (2) and `max_queue_depth` (0, unbounded) configure
    it; each of the four comes from the URL or as a keyword, the URL
    winning.

    `cache=1` (or the `decision_cache=True` keyword, or the
    DECISION_CACHE switch) puts the decision cache
    (spicedb/decision_cache.py) on top, above the dispatcher, so a warm
    hit returns before any queue or kernel work; `cache_bytes=` (or
    `decision_cache_bytes=`) bounds it (reference endpoints.py:359-398,
    :536-540).  Both schemes are store-backed, so an explicit cache is
    refused only by an endpoint without a store.

    `grpc://host:port`, `grpcs://`, `http://`, `https://` and a
    scheme-less `host:port` (the reference's default shape, options.go:
    107) dial a remote permissions service over gRPC
    (spicedb/grpc_remote.py `RemoteEndpoint`, reference endpoints.py:
    543-568): TLS unless the scheme is `grpc`/`http` or `insecure=True`,
    with `token`, `ca_path` and `skip_verify[_ca]` as the reference
    takes them.  A remote endpoint has no store, so `store=` (a data
    dir) and an explicit decision cache are configuration errors there,
    and a switch-derived cache is dropped."""
    if "://" not in url and url:
        url = "grpcs://" + url
    split = urlsplit(url)
    scheme = split.scheme
    params = parse_qs(split.query)
    cache_on, cache_explicit, cache_bytes = _resolve_cache_config(
        url, params, kwargs)
    store = kwargs.pop("store", None)
    dispatch_kw = {k: kwargs.pop(k) for k in _DISPATCH_PARAMS
                   if k in kwargs}
    if scheme in _REMOTE_SCHEMES:
        return _remote_endpoint(url, split, store, cache_on and cache_explicit,
                                kwargs)
    if scheme == "embedded":
        ep = EmbeddedEndpoint.from_bootstrap(bootstrap, store=store)
        return _wrap_decision_cache(ep, cache_on, cache_explicit,
                                    cache_bytes, url)
    if scheme == "torch":
        from ..ops.torch_endpoint import TorchEndpoint  # lazy: imports torch
        for key in ("device", "kernel"):
            if key not in params:
                continue
            if kwargs.get(key) not in (None, params[key][0]):
                raise EndpointConfigError(
                    f"{key}={params[key][0]!r} in {url!r} conflicts "
                    f"with {key}={kwargs[key]!r}")
            kwargs[key] = params[key][0]
        unknown = set(params) - {"device", "kernel", "mesh", "distributed",
                                 *_DISPATCH_PARAMS, *_CACHE_PARAMS}
        if unknown:
            raise EndpointConfigError(
                f"unsupported torch:// parameters {sorted(unknown)} in {url!r}")
        for k in _DISPATCH_PARAMS:
            if k in params:
                dispatch_kw[k] = params[k][0]
        distributed = _torch_distributed(params, url)
        mesh_param = (params.get("mesh") or [""])[0]
        if mesh_param and "mesh" not in kwargs:
            mesh = _torch_mesh(mesh_param, kwargs.get("device"), url,
                               distributed)
            if mesh is not None:
                kwargs["mesh"] = mesh
        mesh = kwargs.get("mesh")
        if mesh is not None and mesh.world > 1:
            _refuse_unordered_serving(dispatch_kw, cache_on, url, mesh.world)
        if store is not None:
            kwargs["store"] = store
        ep = TorchEndpoint.from_bootstrap(bootstrap, **kwargs)
        return _wrap_decision_cache(_wrap_dispatch(ep, dispatch_kw, url),
                                    cache_on, cache_explicit, cache_bytes,
                                    url)
    raise EndpointConfigError(
        f"unsupported spicedb endpoint scheme {scheme!r} "
        f"(this package serves embedded://, torch:// and the remote "
        f"grpc://, grpcs://, http://, https://)")


_DISPATCH_PARAMS = ("dispatch", "max_batch", "pipeline_depth",
                    "max_queue_depth")
_REMOTE_SCHEMES = ("grpc", "grpcs", "http", "https")


def _remote_endpoint(url: str, split, store, cache_explicit: bool,
                     kwargs: dict) -> PermissionsEndpoint:
    """The remote branch of create_endpoint (reference endpoints.py:
    425-436, 543-568)."""
    if store is not None:
        raise EndpointConfigError(
            f"--data-dir persistence requires a store-backed endpoint "
            f"(embedded:// or torch://), not {url!r}")
    if cache_explicit:
        raise EndpointConfigError(
            f"--decision-cache requires a store-backed endpoint "
            f"(embedded:// or torch://), not {url!r}")
    from .grpc_remote import RemoteEndpoint, _grpc
    try:
        _grpc()
    except ImportError as e:
        raise EndpointConfigError(
            f"remote endpoint {url!r} requires grpcio: {e}") from e
    target = split.netloc or split.path
    if not target:
        raise EndpointConfigError(f"remote endpoint {url!r} has no host")
    insecure = split.scheme in ("grpc", "http") or bool(kwargs.get("insecure"))
    ca_pem = None
    ca_path = kwargs.get("ca_path") or ""
    if ca_path:
        with open(ca_path, "rb") as f:
            ca_pem = f.read()
    return RemoteEndpoint(target, token=kwargs.get("token", ""),
                          insecure=insecure, ca_pem=ca_pem,
                          skip_verify=bool(kwargs.get("skip_verify")
                                           or kwargs.get("skip_verify_ca")))
_CACHE_PARAMS = ("cache", "cache_bytes")


def _resolve_cache_config(url: str, params: dict, kwargs: dict) -> tuple:
    """The decision-cache wiring for create_endpoint: the explicit
    keyword (the CLI's --decision-cache), else the `?cache=` URL
    parameter, else the DECISION_CACHE switch turns it on.  Returns
    (enabled, explicit, max_bytes) after POPPING the cache keywords so
    the backends never see them; `explicit` tells a requested cache (an
    endpoint that cannot hold one raises) from a switch-derived default
    (dropped silently there)."""
    want = kwargs.pop("decision_cache", None)
    max_bytes = kwargs.pop("decision_cache_bytes", None)
    explicit = want is not None
    raw = (params.get("cache") or [""])[0].lower()
    if want is None:
        if raw in ("1", "true", "yes"):
            want, explicit = True, True
        elif raw in ("0", "false", "no"):
            want, explicit = False, True
        elif raw == "":
            from ..utils import features
            want = features.DECISION_CACHE is True
        else:
            raise EndpointConfigError(
                f"invalid cache={raw!r} in {url!r} "
                f"(expected 1/true/yes/0/false/no)")
    raw_bytes = (params.get("cache_bytes") or [""])[0]
    if raw_bytes:
        try:
            max_bytes = int(raw_bytes)
        except ValueError as e:
            raise EndpointConfigError(
                f"invalid cache_bytes in {url!r}: {e}") from e
    return bool(want), explicit, max_bytes


def _wrap_decision_cache(ep: PermissionsEndpoint, on: bool, explicit: bool,
                         max_bytes: Optional[int],
                         url: str) -> PermissionsEndpoint:
    """`ep` behind the decision cache when `on` (see create_endpoint)."""
    if not on:
        return ep
    if getattr(ep, "store", None) is None:
        if explicit:
            raise EndpointConfigError(
                f"--decision-cache requires a store-backed endpoint, "
                f"not {url!r}")
        return ep   # switch-derived default: inapplicable, not fatal
    from .decision_cache import DEFAULT_MAX_BYTES, DecisionCacheEndpoint
    try:
        return DecisionCacheEndpoint(
            ep, max_bytes=max_bytes if max_bytes else DEFAULT_MAX_BYTES)
    except ValueError as e:
        raise EndpointConfigError(
            f"invalid cache_bytes in {url!r}: {e}") from e


def _wrap_dispatch(ep: PermissionsEndpoint, kw: dict,
                   url: str) -> PermissionsEndpoint:
    """`ep` behind the batching dispatcher, or bare under
    `dispatch=direct` (see create_endpoint)."""
    from ..utils import features
    default = "batched" if features.CROSS_REQUEST_BATCHING else "direct"
    dispatch = kw.get("dispatch") or default
    if dispatch == "direct":
        return ep
    if dispatch != "batched":
        raise EndpointConfigError(
            f"unknown dispatch mode {dispatch!r}; use batched|direct")
    from .dispatch import BatchingEndpoint

    def arg(name: str, default: int) -> int:
        v = kw.get(name)
        return default if v is None else int(v)

    try:
        return BatchingEndpoint(
            ep, max_batch=arg("max_batch", 4096),
            pipeline_depth=arg("pipeline_depth", 2),
            max_queue_depth=arg("max_queue_depth", 0))
    except ValueError as e:
        raise EndpointConfigError(
            f"invalid max_batch/pipeline_depth/max_queue_depth "
            f"in {url!r}: {e}") from e


def _refuse_unordered_serving(dispatch_kw: dict, cache_on: bool, url: str,
                              world: int) -> None:
    """A mesh across processes is SPMD: every rank must run the same
    collectives on the same batches in the same order.  The batching
    dispatcher fuses whatever is queued when it drains, and keeps two
    batches in flight, so two ranks fed the same requests can cut and
    order their batches differently; a decision-cache hit on one rank
    skips the sweep the others wait in.  Either would hang the
    collectives or sum answers to different queries, so both are
    refused, also where a switch and not the URL turned them on."""
    from ..utils import features
    dispatch = dispatch_kw.get("dispatch") or (
        "batched" if features.CROSS_REQUEST_BATCHING else "direct")
    if dispatch == "batched":
        raise EndpointConfigError(
            f"{url!r}: the batching dispatcher is not served on a mesh "
            f"across {world} processes (ranks would cut different "
            f"batches); pass dispatch=direct")
    if cache_on:
        raise EndpointConfigError(
            f"{url!r}: the decision cache is not served on a mesh across "
            f"{world} processes (a hit on one rank skips the collectives "
            f"the others wait in); pass cache=0 or turn the "
            f"DecisionCache gate off")


def _torch_distributed(params: dict, url: str) -> bool:
    """`torch://?distributed=1|true|yes|auto|0|false|no`, as `jax://`
    takes it (reference endpoints.py:443-465): join the process group
    named by the SPICEDB_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID env
    triplet (else `env://`) BEFORE any mesh is built, so the mesh spans
    every rank.  `1` is strict (an authz proxy must not silently serve
    over a partial mesh); `auto` is best-effort.  True when this process
    is in a process group."""
    dist_param = (params.get("distributed") or ["0"])[0].lower()
    if dist_param in ("1", "true", "yes", "auto"):
        from ..parallel import distributed
        try:
            return bool(distributed.init_from_env(
                strict=dist_param != "auto"))
        except Exception as e:
            raise EndpointConfigError(
                f"distributed={dist_param} in {url!r}: torch.distributed "
                f"initialization failed: {e}") from e
    if dist_param not in ("0", "false", "no", ""):
        raise EndpointConfigError(
            f"invalid distributed={dist_param!r} in {url!r} "
            f"(expected 1/true/yes/auto/0/false/no)")
    return False


def _torch_mesh(param: str, device, url: str, distributed: bool = False):
    """The mesh a `torch://?mesh=` value asks for, or None (see
    create_endpoint).  In a process group the mesh spans every rank:
    `auto` puts one shard on each rank's card (none in a one-rank
    world), `DxG` places D*G shards (a multiple of the world size) row
    by row over the ranks, each rank's on its own card (the CPU with
    `device=cpu`)."""
    import torch

    from ..parallel.sharding import make_mesh, make_process_mesh
    from ..utils import features
    if not features.MESH_EXECUTION:
        if param != "auto":
            raise EndpointConfigError(
                f"mesh={param!r} in {url!r} requires the MeshExecution "
                f"feature gate (disabled)")
        return None
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if distributed:
        from ..parallel.distributed import world
        try:
            if param == "auto":
                return make_process_mesh(device=device) \
                    if world()[1] > 1 else None
            data_s, _, graph_s = param.partition("x")
            return make_process_mesh(int(data_s), int(graph_s),
                                     device=device)
        except ValueError as e:
            raise EndpointConfigError(
                f"invalid mesh {param!r} in {url!r}: {e}") from e
    if param == "auto":
        n = 1 if on_cpu else torch.cuda.device_count()
        return make_mesh() if n > 1 else None
    try:
        data_s, _, graph_s = param.partition("x")
        d, g = int(data_s), int(graph_s)
        if d < 1 or g < 1:
            raise ValueError(f"mesh axes must be positive, got {d}x{g}")
        if on_cpu:
            return make_mesh([torch.device("cpu")] * (d * g), data=d,
                             graph=g)
        n = torch.cuda.device_count()
        if d * g > n:
            raise ValueError(f"mesh {d}x{g} needs {d * g} devices, have {n}")
        # an explicit DxG smaller than the host takes the first d*g cards
        return make_mesh([torch.device("cuda", i) for i in range(d * g)],
                         data=d, graph=g)
    except ValueError as e:
        raise EndpointConfigError(
            f"invalid mesh {param!r} in {url!r}: {e}") from e
