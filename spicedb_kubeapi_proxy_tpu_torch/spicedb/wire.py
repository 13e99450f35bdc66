"""Minimal protobuf wire-format codecs for the authzed.api.v1 subset
(the reference's spicedb/wire.py, copied: every encoder gives the same
bytes, every decoder the same objects).

The remote endpoint (`grpc://`, reference options.go:331-368) and the
standalone authz gRPC server (permsd.py) speak the seven verbs the proxy
consumes.  gRPC only needs `request_serializer` / `response_deserializer`
callables, so rather than depending on generated stubs the handful of
messages are encoded and decoded directly in the protobuf wire format:
varint tags, length-delimited submessages.  Nothing here imports grpc,
so the codecs (and the server's handlers) load where grpcio is absent.

Field numbers follow the public authzed.api.v1 protos.  Wire compatibility
is pinned by golden fixtures (tests/test_wire_golden.py): literal
hand-assembled byte strings plus cross-validation against the real
protobuf runtime via dynamic descriptors mirroring authzed.api.v1 —
byte-identical encoding for the request messages, parse-identical both
directions for the rest:

  ObjectReference        { object_type=1, object_id=2 }
  SubjectReference       { object=1, optional_relation=2 }
  Relationship           { resource=1, relation=2, subject=3,
                           optional_caveat=4 (ContextualizedCaveat{
                             caveat_name=1, context=2 (Struct) }),
                           optional_expires_at=5 (Timestamp) }
  ZedToken               { token=1 }
  Consistency            { fully_consistent=4 }   (always sent)
  RelationshipFilter     { resource_type=1, optional_resource_id=2,
                           optional_relation=3, optional_subject_filter=4 }
  SubjectFilter          { subject_type=1, optional_subject_id=2,
                           optional_relation=3 { relation=1 } }
  Precondition           { operation=1, filter=2 }
  RelationshipUpdate     { operation=1, relationship=2 }
  CheckPermissionRequest { consistency=1, resource=2, permission=3, subject=4 }
  CheckPermissionResponse{ checked_at=1, permissionship=2 }
  CheckBulkPermissionsRequest  { consistency=1, items=2 }
  CheckBulkPermissionsRequestItem { resource=1, permission=2, subject=3 }
  CheckBulkPermissionsResponse { checked_at=1, pairs=2 }
  CheckBulkPermissionsPair     { request=1, item=2 { permissionship=1 } }
  LookupResourcesRequest { consistency=1, resource_object_type=2,
                           permission=3, subject=4 }
  LookupResourcesResponse{ looked_up_at=1, resource_object_id=2,
                           permissionship=3 }
  ReadRelationshipsRequest { consistency=1, relationship_filter=2 }
  ReadRelationshipsResponse{ read_at=1, relationship=2 }
  WriteRelationshipsRequest{ updates=1, optional_preconditions=2 }
  WriteRelationshipsResponse{ written_at=1 }
  DeleteRelationshipsRequest{ relationship_filter=1, optional_preconditions=2 }
  DeleteRelationshipsResponse{ deleted_at=1 }
  WatchRequest           { optional_object_types=1 }
  WatchResponse          { updates=1, changes_through=2 }

Permissionship enum: 1=NO_PERMISSION, 2=HAS_PERMISSION, 3=CONDITIONAL.
RelationshipUpdate.Operation: 1=CREATE, 2=TOUCH, 3=DELETE.
Precondition.Operation: 1=MUST_NOT_MATCH, 2=MUST_MATCH.
"""

from __future__ import annotations

import math
import struct
from typing import Iterator, Optional

from .types import (
    CheckRequest,
    CheckResult,
    ObjectRef,
    Permissionship,
    Precondition,
    PreconditionOp,
    Relationship,
    RelationshipFilter,
    RelationshipUpdate,
    SubjectFilter,
    SubjectRef,
    UpdateOp,
)

# -- wire primitives ---------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _len_field(field: int, payload: bytes) -> bytes:
    if not payload:
        return b""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _len_field_present(field: int, payload: bytes) -> bytes:
    """Like _len_field but emits the field even when the payload is empty
    (submessage presence, e.g. an empty RelationFilter meaning
    'direct subjects only')."""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, value: str) -> bytes:
    return _len_field(field, value.encode("utf-8"))


def _varint_field(field: int, value: int) -> bytes:
    if not value:
        return b""
    return _tag(field, 0) + _varint(value)


def _read_varint(buf: bytes, pos: int) -> tuple:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def fields(buf: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) over a message buffer.
    Length-delimited values come back as bytes; varints as int."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            value, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            value = buf[pos: pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            value = buf[pos: pos + 4]
            pos += 4
        elif wt == 1:  # fixed64
            value = buf[pos: pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, value


def _submessages(buf: bytes, field: int) -> list:
    return [v for f, wt, v in fields(buf) if f == field and wt == 2]


def _first(buf: bytes, field: int, default=None):
    for f, wt, v in fields(buf):
        if f == field:
            return v
    return default


def _first_str(buf: bytes, field: int, default: str = "") -> str:
    v = _first(buf, field)
    return v.decode("utf-8") if isinstance(v, bytes) else default


# -- core types --------------------------------------------------------------


def enc_object(ref: ObjectRef) -> bytes:
    return _str_field(1, ref.type) + _str_field(2, ref.id)


def dec_object(buf: bytes) -> ObjectRef:
    return ObjectRef(_first_str(buf, 1), _first_str(buf, 2))


def enc_subject(ref: SubjectRef) -> bytes:
    return (_len_field(1, enc_object(ObjectRef(ref.type, ref.id)))
            + _str_field(2, ref.relation))


def dec_subject(buf: bytes) -> SubjectRef:
    obj = dec_object(_first(buf, 1, b""))
    return SubjectRef(obj.type, obj.id, _first_str(buf, 2))


def _enc_timestamp(unix_seconds: float) -> bytes:
    seconds = int(math.floor(unix_seconds))
    nanos = int(round((unix_seconds - seconds) * 1e9))
    return _varint_field(1, seconds) + _varint_field(2, nanos)


def _dec_timestamp(buf: bytes) -> float:
    seconds = _first(buf, 1, 0)
    nanos = _first(buf, 2, 0)
    return float(seconds) + float(nanos) / 1e9


# -- google.protobuf.Struct (caveat context) ---------------------------------
# Value oneof: null_value=1 (varint), number_value=2 (double/fixed64),
# string_value=3, bool_value=4 (varint), struct_value=5, list_value=6.
# Oneof fields must be emitted even for zero values, so the generic
# zero-dropping helpers are bypassed here.

def _enc_value(v) -> bytes:
    if v is None:
        return _tag(1, 0) + _varint(0)
    if isinstance(v, bool):
        return _tag(4, 0) + _varint(1 if v else 0)
    if isinstance(v, (int, float)):
        return _tag(2, 1) + struct.pack("<d", float(v))
    if isinstance(v, str):
        return _len_field_present(3, v.encode("utf-8"))
    if isinstance(v, dict):
        return _len_field_present(5, _enc_struct(v))
    if isinstance(v, (list, tuple)):
        payload = b"".join(_len_field_present(1, _enc_value(x)) for x in v)
        return _len_field_present(6, payload)
    raise ValueError(f"unsupported caveat context value {type(v).__name__}")


def _dec_value(buf: bytes):
    for f, wt, v in fields(buf):
        if f == 1:
            return None
        if f == 2:
            num = struct.unpack("<d", v)[0]
            # integral doubles come back as ints so JSON contexts
            # round-trip exactly ({"n": 1} -> 1, not 1.0)
            return int(num) if num.is_integer() else num
        if f == 3:
            return v.decode("utf-8")
        if f == 4:
            return bool(v)
        if f == 5:
            return _dec_struct(v)
        if f == 6:
            return [_dec_value(x) for x in _submessages(v, 1)]
    return None


def _enc_struct(d: dict) -> bytes:
    # Struct{ map<string, Value> fields = 1 }; map entries are
    # { key=1, value=2 } submessages
    out = b""
    for k, v in d.items():
        entry = _str_field(1, k) + _len_field_present(2, _enc_value(v))
        out += _len_field_present(1, entry)
    return out


def _dec_struct(buf: bytes) -> dict:
    out = {}
    for entry in _submessages(buf, 1):
        key = _first_str(entry, 1)
        val = _first(entry, 2, b"")
        out[key] = _dec_value(val)
    return out


def _enc_caveat(caveat) -> bytes:
    """ContextualizedCaveat{ caveat_name=1, context=2 (Struct) }."""
    out = _str_field(1, caveat.name)
    ctx = caveat.context()
    if ctx:
        out += _len_field_present(2, _enc_struct(ctx))
    return out


def _dec_caveat(buf: bytes):
    from .types import CaveatRef
    ctx_buf = _first(buf, 2)
    return CaveatRef.make(
        _first_str(buf, 1),
        _dec_struct(ctx_buf) if ctx_buf is not None else None)


def enc_relationship(rel: Relationship) -> bytes:
    out = (_len_field(1, enc_object(rel.resource))
           + _str_field(2, rel.relation)
           + _len_field(3, enc_subject(rel.subject)))
    if rel.caveat is not None:
        out += _len_field_present(4, _enc_caveat(rel.caveat))
    if rel.expires_at is not None:
        out += _len_field(5, _enc_timestamp(rel.expires_at))
    return out


def dec_relationship(buf: bytes) -> Relationship:
    cav = _first(buf, 4)
    ts = _first(buf, 5)
    return Relationship(
        resource=dec_object(_first(buf, 1, b"")),
        relation=_first_str(buf, 2),
        subject=dec_subject(_first(buf, 3, b"")),
        caveat=_dec_caveat(cav) if cav is not None else None,
        expires_at=_dec_timestamp(ts) if ts is not None else None,
    )


def enc_zedtoken(revision: int) -> bytes:
    return _str_field(1, str(revision))


def dec_zedtoken(buf: Optional[bytes]) -> int:
    if not buf:
        return 0
    try:
        return int(_first_str(buf, 1) or 0)
    except ValueError:
        return 0


def enc_consistency_full() -> bytes:
    return _varint_field(4, 1)  # fully_consistent = true


def enc_rel_filter(flt: RelationshipFilter) -> bytes:
    out = (_str_field(1, flt.resource_type)
           + _str_field(2, flt.resource_id)
           + _str_field(3, flt.relation))
    if flt.subject is not None:
        sub = (_str_field(1, flt.subject.type)
               + _str_field(2, flt.subject.id))
        if flt.subject.relation is not None:
            sub += _len_field_present(3, _str_field(1, flt.subject.relation))
        out += _len_field_present(4, sub)
    return out


def dec_rel_filter(buf: bytes) -> RelationshipFilter:
    sub = _first(buf, 4)
    subject = None
    if sub is not None:
        rel_wrap = _first(sub, 3)
        subject = SubjectFilter(
            type=_first_str(sub, 1),
            id=_first_str(sub, 2),
            relation=(_first_str(rel_wrap, 1) if rel_wrap is not None else None),
        )
    return RelationshipFilter(
        resource_type=_first_str(buf, 1),
        resource_id=_first_str(buf, 2),
        relation=_first_str(buf, 3),
        subject=subject,
    )


_PRECOND_OP = {PreconditionOp.MUST_NOT_MATCH: 1, PreconditionOp.MUST_MATCH: 2}
_PRECOND_OP_R = {v: k for k, v in _PRECOND_OP.items()}


def enc_precondition(p: Precondition) -> bytes:
    return (_varint_field(1, _PRECOND_OP[p.op])
            + _len_field(2, enc_rel_filter(p.filter)))


def dec_precondition(buf: bytes) -> Precondition:
    return Precondition(
        op=_PRECOND_OP_R.get(_first(buf, 1, 2), PreconditionOp.MUST_MATCH),
        filter=dec_rel_filter(_first(buf, 2, b"")),
    )


_UPDATE_OP = {UpdateOp.CREATE: 1, UpdateOp.TOUCH: 2, UpdateOp.DELETE: 3}
_UPDATE_OP_R = {v: k for k, v in _UPDATE_OP.items()}


def enc_update(u: RelationshipUpdate) -> bytes:
    return (_varint_field(1, _UPDATE_OP[u.op])
            + _len_field(2, enc_relationship(u.rel)))


def dec_update(buf: bytes) -> RelationshipUpdate:
    return RelationshipUpdate(
        op=_UPDATE_OP_R.get(_first(buf, 1, 2), UpdateOp.TOUCH),
        rel=dec_relationship(_first(buf, 2, b"")),
    )


_PERMISSIONSHIP = {
    Permissionship.NO_PERMISSION: 1,
    Permissionship.HAS_PERMISSION: 2,
    Permissionship.CONDITIONAL_PERMISSION: 3,
}
_PERMISSIONSHIP_R = {v: k for k, v in _PERMISSIONSHIP.items()}


# -- requests/responses ------------------------------------------------------


def enc_check_request(req: CheckRequest) -> bytes:
    return (_len_field(1, enc_consistency_full())
            + _len_field(2, enc_object(req.resource))
            + _str_field(3, req.permission)
            + _len_field(4, enc_subject(req.subject)))


def dec_check_request(buf: bytes) -> CheckRequest:
    return CheckRequest(
        resource=dec_object(_first(buf, 2, b"")),
        permission=_first_str(buf, 3),
        subject=dec_subject(_first(buf, 4, b"")),
    )


def enc_check_response(res: CheckResult) -> bytes:
    return (_len_field(1, enc_zedtoken(res.checked_at))
            + _varint_field(2, _PERMISSIONSHIP[res.permissionship]))


def dec_check_response(buf: bytes) -> CheckResult:
    return CheckResult(
        permissionship=_PERMISSIONSHIP_R.get(
            _first(buf, 2, 1), Permissionship.NO_PERMISSION),
        checked_at=dec_zedtoken(_first(buf, 1)),
    )


def enc_bulk_request(reqs: list) -> bytes:
    out = _len_field(1, enc_consistency_full())
    for r in reqs:
        item = (_len_field(1, enc_object(r.resource))
                + _str_field(2, r.permission)
                + _len_field(3, enc_subject(r.subject)))
        out += _len_field(2, item)
    return out


def dec_bulk_request(buf: bytes) -> list:
    out = []
    for item in _submessages(buf, 2):
        out.append(CheckRequest(
            resource=dec_object(_first(item, 1, b"")),
            permission=_first_str(item, 2),
            subject=dec_subject(_first(item, 3, b"")),
        ))
    return out


def enc_bulk_response(revision: int, results: list) -> bytes:
    out = _len_field(1, enc_zedtoken(revision))
    for res in results:
        item = _varint_field(1, _PERMISSIONSHIP[res.permissionship])
        out += _len_field(2, _len_field(2, item))
    return out


def dec_bulk_response(buf: bytes) -> list:
    rev = dec_zedtoken(_first(buf, 1))
    out = []
    for pair in _submessages(buf, 2):
        item = _first(pair, 2, b"")
        out.append(CheckResult(
            permissionship=_PERMISSIONSHIP_R.get(
                _first(item, 1, 1), Permissionship.NO_PERMISSION),
            checked_at=rev,
        ))
    return out


def enc_lookup_request(resource_type: str, permission: str,
                       subject: SubjectRef) -> bytes:
    return (_len_field(1, enc_consistency_full())
            + _str_field(2, resource_type)
            + _str_field(3, permission)
            + _len_field(4, enc_subject(subject)))


def dec_lookup_request(buf: bytes) -> tuple:
    return (_first_str(buf, 2), _first_str(buf, 3),
            dec_subject(_first(buf, 4, b"")))


def enc_lookup_response(revision: int, resource_id: str) -> bytes:
    return (_len_field(1, enc_zedtoken(revision))
            + _str_field(2, resource_id)
            + _varint_field(3, 2))  # HAS_PERMISSION (conditional are skipped)


def dec_lookup_response(buf: bytes) -> tuple:
    """(resource_id, permissionship).  FAIL CLOSED like the check
    decoders: an absent permissionship field (proto3 zero = UNSPECIFIED)
    or an unknown enum value decodes as NO_PERMISSION, so it can never
    slip past the client's HAS-only filter into an allowed-set."""
    return (_first_str(buf, 2),
            _PERMISSIONSHIP_R.get(_first(buf, 3, 0),
                                  Permissionship.NO_PERMISSION))


def enc_read_request(flt: Optional[RelationshipFilter]) -> bytes:
    out = _len_field(1, enc_consistency_full())
    if flt is not None:
        out += _len_field_present(2, enc_rel_filter(flt))
    return out


def dec_read_request(buf: bytes) -> Optional[RelationshipFilter]:
    flt = _first(buf, 2)
    return dec_rel_filter(flt) if flt is not None else None


def enc_read_response(revision: int, rel: Relationship) -> bytes:
    return (_len_field(1, enc_zedtoken(revision))
            + _len_field(2, enc_relationship(rel)))


def dec_read_response(buf: bytes) -> Relationship:
    return dec_relationship(_first(buf, 2, b""))


def enc_write_request(updates: list, preconditions: list) -> bytes:
    out = b""
    for u in updates:
        out += _len_field(1, enc_update(u))
    for p in preconditions:
        out += _len_field(2, enc_precondition(p))
    return out


def dec_write_request(buf: bytes) -> tuple:
    return ([dec_update(u) for u in _submessages(buf, 1)],
            [dec_precondition(p) for p in _submessages(buf, 2)])


def enc_write_response(revision: int) -> bytes:
    return _len_field(1, enc_zedtoken(revision))


def dec_write_response(buf: bytes) -> int:
    return dec_zedtoken(_first(buf, 1))


def enc_delete_request(flt: RelationshipFilter, preconditions: list) -> bytes:
    out = _len_field_present(1, enc_rel_filter(flt))
    for p in preconditions:
        out += _len_field(2, enc_precondition(p))
    return out


def dec_delete_request(buf: bytes) -> tuple:
    return (dec_rel_filter(_first(buf, 1, b"")),
            [dec_precondition(p) for p in _submessages(buf, 2)])


def enc_delete_response(revision: int) -> bytes:
    return _len_field(1, enc_zedtoken(revision))


def dec_delete_response(buf: bytes) -> int:
    return dec_zedtoken(_first(buf, 1))


def enc_watch_request(object_types: Optional[list]) -> bytes:
    out = b""
    for t in object_types or ():
        out += _str_field(1, t)
    return out


def dec_watch_request(buf: bytes) -> Optional[list]:
    types = [v.decode("utf-8") for f, wt, v in fields(buf)
             if f == 1 and wt == 2]
    return types or None


def enc_watch_response(revision: int, updates: list) -> bytes:
    out = b""
    for u in updates:
        out += _len_field(1, enc_update(u))
    out += _len_field(2, enc_zedtoken(revision))
    return out


def dec_watch_response(buf: bytes) -> tuple:
    """(revision, [RelationshipUpdate])"""
    return (dec_zedtoken(_first(buf, 2)),
            [dec_update(u) for u in _submessages(buf, 1)])
