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
"""

MESH_EXECUTION = True
CROSS_REQUEST_BATCHING = True
DEVICE_PIPELINE = True
ADMISSION_CONTROL = True
ASYNC_REBUILD = True


def pipeline_enabled() -> bool:
    """The DevicePipeline switch, read at each drain."""
    return DEVICE_PIPELINE
