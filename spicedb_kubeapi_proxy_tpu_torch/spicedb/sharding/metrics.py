"""Sharding telemetry behind the SHARDING switch (the reference's
spicedb/sharding/metrics.py; series of its docs/observability.md:110-112).

Every recording helper reads the switch first: off, nothing here ticks,
as a single-shard proxy ticks nothing.  Label cardinality is bounded by
configuration: `shard` is one of the configured 0..N-1 ids, `verb` one
of the fixed fan-out verbs."""

from __future__ import annotations

from ...utils.metrics import REGISTRY

_routed = REGISTRY.counter(
    "authz_shard_routed_total",
    "Requests/verbs routed to a single shard leader (router + "
    "in-process sharded endpoint)", labels=("shard",))
_fanout = REGISTRY.counter(
    "authz_shard_fanout_total",
    "Cross-shard fan-out operations by verb (read/delete_by_filter/"
    "bulk/watch/health)", labels=("verb",))
_cross_rejects = REGISTRY.counter(
    "authz_shard_cross_write_rejects_total",
    "Write batches rejected for spanning two shards (unroutable; the "
    "footprint validation makes this unreachable for rule-generated "
    "dual-writes)")


def enabled() -> bool:
    """The SHARDING switch, read at each use."""
    from ...utils import features
    return features.SHARDING is True


def note_routed(shard: int) -> None:
    if enabled():
        _routed.inc(shard=str(shard))


def note_fanout(verb: str) -> None:
    if enabled():
        _fanout.inc(verb=verb)


def note_cross_write_reject() -> None:
    if enabled():
        _cross_rejects.inc()
