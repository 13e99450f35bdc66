"""Feature switches of the torch port, module constants read at use.

- `MESH_EXECUTION` is the killswitch of the sharded mesh path behind
  `torch://?mesh=` (the reference's `MeshExecution` gate,
  utils/features.py:168, default on).  Off, `torch://?mesh=auto` builds
  no mesh and an explicit `mesh=DxG` is a configuration error, as in the
  reference.
- `CROSS_REQUEST_BATCHING` makes batched dispatch the default of
  `torch://` (the reference's `CrossRequestBatching` gate, :86).  Off,
  the factory returns the bare endpoint unless `dispatch=batched` is
  asked for.
- `DEVICE_PIPELINE` lets the dispatcher keep started fused batches in
  flight (the reference's `DevicePipeline` gate, :110, read through
  `pipeline_enabled()`, :199).  Off, checks run serially and lookups keep
  a single-slot two-phase window.
- `ADMISSION_CONTROL` arms the dispatcher's queue bounds (the
  reference's `AdmissionControl` gate, :123).  Off, a configured bound is
  inert.
- `ASYNC_REBUILD` moves graph rebuilds off the request path (the
  reference's `AsyncRebuild` gate, :111-117): a delta the live
  generation cannot absorb quarantines its (type, permission) closure to
  the host oracle while a candidate builds on a background thread, and a
  spare pool under its low watermark rebuilds there before it runs dry.
  Off, such a delta rebuilds synchronously under the endpoint lock, as
  before.  Read at each use; a missing switch reads as off.
- `DECISION_CACHE` puts the revision-keyed decision cache
  (spicedb/decision_cache.py) in front of every store-backed endpoint
  the factory builds (the reference's `DecisionCache` gate, :91, ALPHA,
  default off); `?cache=` in the URL or `--decision-cache` win over it.
- `DEVICE_TELEMETRY` is the killswitch of the HBM ledger, the kernel
  accounting, batch occupancy and the flight recorder (utils/devtel.py;
  the reference's `DeviceTelemetry` gate, :101).
- `TIMELINE` is the killswitch of the dispatch timeline
  (utils/timeline.py; the reference's `Timeline` gate, :106).
- `KERNEL_INTROSPECT` is the killswitch of the sweep telemetry and the
  workload attribution (utils/workload.py; the reference's
  `KernelIntrospect` gate, :148).  The sweeps compute their trace either
  way (the host loop needs it to stop); off, nothing records it.
- `PROFILER` lets `/debug/profile` sample (utils/profiler.py; the
  reference's `Profiler` gate, :154, ALPHA, default on).
- `DURABLE_STORE` is the killswitch of the durable store
  (spicedb/persist; the reference's `DurableStore` gate, :94): off, a
  configured data dir is inert and the store runs in memory.
- `REPLICATION` is the killswitch of WAL-shipping replication
  (spicedb/replication; the reference's `Replication` gate, :129): off,
  the `/replication/*` routes answer 503 and a configured
  `replicate_from` is inert, so the proxy is exactly single-node.
- `SHARDING` is the killswitch of tuple-space sharding (spicedb/sharding;
  the reference's `Sharding` gate, :136-141, default on): off, a
  configured shard count is inert and the proxy is exactly single-shard,
  the shard metrics tick nothing, and the `--shard-leaders` router
  passes every request through to the default shard untouched.
- `TAIL_EXPLAIN` is the killswitch of the tail explainer
  (utils/tailexplain.py; the reference's `TailExplain` gate, :186,
  default on): off, /debug/tail answers enabled:false and computes no
  report.  Trace collection and fleet propagation follow TIMELINE.

- `LEOPARD_INDEX` is the default of `TorchEndpoint(leopard=)`: with it
  on, every generation builds the Leopard closure index (the reference's
  `LeopardIndex` gate, :179, read at endpoint construction as there).
- `STRUCTURED_REQUEST_LOG` adds the request's key=value fields to the
  proxy's request log line (the reference's `StructuredRequestLog` gate,
  :85; proxy/server.py).
- `CONTEXTUAL_LOGGING`, `LOGGING_ALPHA_OPTIONS` and
  `LOGGING_BETA_OPTIONS` are the component-base logging gates the
  reference registers (:81-83) and reads nowhere.  They are accepted and
  kept, so that a command line written for the reference runs unchanged.
- `FUZZ_TELEMETRY` is the killswitch of the fuzz harness's
  `authz_fuzz_*` counters (the reference's `FuzzTelemetry` gate, :134),
  read at every record by fuzz/metrics.py: off, the harness records
  nothing.

`apply_flag` sets them from the CLI's `--feature-gates name=true|false`
under the reference's gate names (`GATE_SWITCHES`, all 20 of the
reference's); any other name is refused, as the reference refuses a gate
it does not know.
"""

MESH_EXECUTION = True
CROSS_REQUEST_BATCHING = True
DEVICE_PIPELINE = True
ADMISSION_CONTROL = True
ASYNC_REBUILD = True
DECISION_CACHE = False
DEVICE_TELEMETRY = True
TIMELINE = True
KERNEL_INTROSPECT = True
PROFILER = True
DURABLE_STORE = True
REPLICATION = True
SHARDING = True
TAIL_EXPLAIN = True
LEOPARD_INDEX = True
STRUCTURED_REQUEST_LOG = True
CONTEXTUAL_LOGGING = True
LOGGING_ALPHA_OPTIONS = False
LOGGING_BETA_OPTIONS = True
FUZZ_TELEMETRY = True


def pipeline_enabled() -> bool:
    """The DevicePipeline switch, read at each drain."""
    return DEVICE_PIPELINE


# the reference's gate name of each switch (utils/features.py there)
GATE_SWITCHES = {
    "MeshExecution": "MESH_EXECUTION",
    "CrossRequestBatching": "CROSS_REQUEST_BATCHING",
    "DevicePipeline": "DEVICE_PIPELINE",
    "AdmissionControl": "ADMISSION_CONTROL",
    "AsyncRebuild": "ASYNC_REBUILD",
    "DecisionCache": "DECISION_CACHE",
    "DeviceTelemetry": "DEVICE_TELEMETRY",
    "Timeline": "TIMELINE",
    "KernelIntrospect": "KERNEL_INTROSPECT",
    "Profiler": "PROFILER",
    "DurableStore": "DURABLE_STORE",
    "Replication": "REPLICATION",
    "Sharding": "SHARDING",
    "TailExplain": "TAIL_EXPLAIN",
    "LeopardIndex": "LEOPARD_INDEX",
    "StructuredRequestLog": "STRUCTURED_REQUEST_LOG",
    "ContextualLogging": "CONTEXTUAL_LOGGING",
    "LoggingAlphaOptions": "LOGGING_ALPHA_OPTIONS",
    "LoggingBetaOptions": "LOGGING_BETA_OPTIONS",
    "FuzzTelemetry": "FUZZ_TELEMETRY",
}


class FeatureGateError(ValueError):
    pass


def apply_flag(spec: str) -> None:
    """Set switches from a `name=true,name2=false` value (the reference's
    component-base syntax; a bare name means true).  Nothing is set when
    any part is refused."""
    values = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, raw = part.partition("=")
        name, raw = name.strip(), raw.strip().lower() or "true"
        if name not in GATE_SWITCHES:
            raise FeatureGateError(f"unknown feature gate {name!r}")
        if raw not in ("true", "false"):
            raise FeatureGateError(
                f"invalid feature gate value {part!r}: want name=true|false")
        values[GATE_SWITCHES[name]] = raw == "true"
    globals().update(values)
