"""Revision-vector ZedTokens for the sharded write path (the reference's
spicedb/sharding/revvec.py; the encoded strings are the reference's byte
for byte, since they are the tokens clients carry).

With one leader, the ZedToken is a single integer revision
(X-Authz-Revision / X-Authz-Min-Revision, spicedb/replication).  With N
independent shard leaders there is no global revision — each shard's
WAL advances on its own — so the client-facing token becomes an encoded
`{shard: revision}` VECTOR:

    0:12,2:7        components for shards 0 and 2
    *:5             legacy floor: applies to EVERY shard (a bare
                    integer token from a pre-sharding client decodes
                    to this)
    12              bare integer == floor 12 (legacy round-trip)

The router owns the vector: on the way in it extracts the single
component for the target shard and forwards it as a bare integer — so
the per-shard leader's existing `X-Authz-Min-Revision` wait-or-forward
gate (proxy/server.py _leader_gate, _replica_gate) runs byte-identical
to the single-leader deployment, enforcing ONLY its own component.  On
the way out the router merges the serving shard's response revision
into the request's vector (pointwise max), so a client threading the
token through reads-after-writes accumulates exactly the components it
has observed — a token ahead of one shard waits/forwards on that shard
only, while every other shard serves immediately.
"""

from __future__ import annotations

from typing import Optional


class RevisionVectorError(ValueError):
    """Malformed revision-vector token."""


class RevisionVector:
    """Immutable-ish {shard: revision} vector with a legacy floor
    component applying to every shard."""

    __slots__ = ("parts", "floor")

    def __init__(self, parts: Optional[dict] = None, floor: int = 0):
        self.parts = dict(parts or {})
        self.floor = int(floor)
        for k, v in self.parts.items():
            if not isinstance(k, int) or k < 0:
                raise RevisionVectorError(f"invalid shard id {k!r}")
            if not isinstance(v, int) or v < 0:
                raise RevisionVectorError(
                    f"invalid revision {v!r} for shard {k}")
        if self.floor < 0:
            raise RevisionVectorError(f"invalid floor revision {floor!r}")

    @classmethod
    def decode(cls, raw: Optional[str]) -> "RevisionVector":
        """Parse a token header value.  Empty/None -> the empty vector;
        a bare integer -> legacy floor; otherwise comma-separated
        `shard:revision` components (`*` = floor)."""
        raw = (raw or "").strip()
        if not raw:
            return cls()
        if raw.isdigit():
            return cls(floor=int(raw))
        parts: dict = {}
        floor = 0
        for piece in raw.split(","):
            piece = piece.strip()
            if not piece:
                continue
            shard_s, colon, rev_s = piece.partition(":")
            shard_s, rev_s = shard_s.strip(), rev_s.strip()
            if not colon or not rev_s.isdigit():
                raise RevisionVectorError(
                    f"invalid revision-vector component {piece!r}: want "
                    f"shard:revision or *:revision")
            rev = int(rev_s)
            if shard_s == "*":
                floor = max(floor, rev)
            elif shard_s.isdigit():
                shard = int(shard_s)
                parts[shard] = max(parts.get(shard, 0), rev)
            else:
                raise RevisionVectorError(
                    f"invalid shard id in component {piece!r}")
        return cls(parts, floor=floor)

    def encode(self) -> str:
        """Header-safe encoding.  A floor-only vector encodes as the
        bare integer (so a legacy token round-trips unchanged through a
        router that touched nothing)."""
        if not self.parts:
            return str(self.floor) if self.floor else ""
        pieces = []
        if self.floor:
            pieces.append(f"*:{self.floor}")
        pieces.extend(f"{k}:{v}" for k, v in sorted(self.parts.items()))
        return ",".join(pieces)

    # -- accessors -----------------------------------------------------------

    @property
    def is_empty(self) -> bool:
        return not self.parts and not self.floor

    def component(self, shard: int) -> int:
        """The minimum revision this token demands of `shard` (0 = no
        demand)."""
        return max(self.parts.get(shard, 0), self.floor)

    # -- merging -------------------------------------------------------------

    def merged(self, shard: int, revision: int) -> "RevisionVector":
        """New vector with `shard`'s component raised to `revision`."""
        parts = dict(self.parts)
        parts[shard] = max(parts.get(shard, 0), int(revision))
        return RevisionVector(parts, floor=self.floor)

    def merged_with(self, other: "RevisionVector") -> "RevisionVector":
        """Pointwise max of two vectors."""
        parts = dict(self.parts)
        for k, v in other.parts.items():
            parts[k] = max(parts.get(k, 0), v)
        return RevisionVector(parts, floor=max(self.floor, other.floor))

    def __eq__(self, other) -> bool:
        return (isinstance(other, RevisionVector)
                and self.parts == other.parts and self.floor == other.floor)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RevisionVector({self.parts}, floor={self.floor})"
