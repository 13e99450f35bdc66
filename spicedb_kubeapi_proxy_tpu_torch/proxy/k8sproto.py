"""Kubernetes protobuf envelope codec (wire-level, schema-free).

The reference decodes/re-encodes negotiated protobuf bodies through the
k8s runtime codec factory (reference pkg/authz/responsefilterer.go:241-301,
rejecting protobuf only for unrecognized GVKs at 278-280).  This build works
at the protobuf WIRE level instead of generated codecs, exploiting the
layout conventions shared by every native Kubernetes API type (see
k8s.io/apimachinery/pkg/runtime/generated.proto and
pkg/apis/meta/v1/generated.proto):

- a serialized body is the 4-byte magic `k8s\x00` + a `runtime.Unknown`
  message: typeMeta=1 (apiVersion=1, kind=2), raw=2, contentEncoding=3,
  contentType=4;
- every list type is `{ ListMeta metadata = 1; repeated Item items = 2; }`;
- every object type carries `ObjectMeta metadata = 1`, and ObjectMeta is
  `{ name = 1; generateName = 2; namespace = 3; ... }`.

Filtering a list therefore never re-encodes items: disallowed `items`
records are SPLICED OUT of the raw bytes (field-2 length-delimited records
are dropped wholesale; everything else is copied verbatim), which both
preserves unknown fields byte-exactly and avoids needing any type schema.
Bodies that don't follow the conventions raise K8sProtoError — the
behavioral analog of the reference's reject-unrecognized path.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

K8S_MAGIC = b"k8s\x00"


class K8sProtoError(ValueError):
    pass


# -- protobuf wire primitives -------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if i >= len(buf):
            raise K8sProtoError("truncated varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise K8sProtoError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def records(buf: bytes) -> Iterator[tuple]:
    """Yield (field_no, wire_type, record_start, record_end, value) for each
    top-level record.  `value` is the payload bytes for length-delimited
    fields, the int for varints, raw bytes otherwise."""
    i = 0
    n = len(buf)
    while i < n:
        start = i
        key, i = _read_varint(buf, i)
        field_no = key >> 3
        wt = key & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
            yield (field_no, wt, start, i, v)
        elif wt == 1:  # fixed64
            if i + 8 > n:
                raise K8sProtoError("truncated fixed64")
            yield (field_no, wt, start, i + 8, buf[i: i + 8])
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            if i + ln > n:
                raise K8sProtoError("truncated length-delimited field")
            yield (field_no, wt, start, i + ln, buf[i: i + ln])
            i += ln
        elif wt == 5:  # fixed32
            if i + 4 > n:
                raise K8sProtoError("truncated fixed32")
            yield (field_no, wt, start, i + 4, buf[i: i + 4])
            i += 4
        else:
            raise K8sProtoError(f"unsupported wire type {wt}")


def field_bytes(buf: bytes, field_no: int) -> Optional[bytes]:
    """Last occurrence of a length-delimited field, or None."""
    out = None
    for f, wt, _, _, v in records(buf):
        if f == field_no and wt == 2:
            out = v
    return out


def _ld(field_no: int, payload: bytes) -> bytes:
    return _write_varint(field_no << 3 | 2) + _write_varint(len(payload)) + payload


# -- the k8s envelope ---------------------------------------------------------

def is_k8s_proto(body: bytes) -> bool:
    return body.startswith(K8S_MAGIC)


def decode_unknown(body: bytes) -> tuple:
    """`k8s\x00` + runtime.Unknown -> (api_version, kind, raw,
    content_type)."""
    if not body.startswith(K8S_MAGIC):
        raise K8sProtoError("missing k8s protobuf magic prefix")
    buf = body[len(K8S_MAGIC):]
    api_version = kind = content_type = ""
    raw = b""
    for f, wt, _, _, v in records(buf):
        if f == 1 and wt == 2:  # TypeMeta
            for f2, wt2, _, _, v2 in records(v):
                if f2 == 1 and wt2 == 2:
                    api_version = v2.decode("utf-8")
                elif f2 == 2 and wt2 == 2:
                    kind = v2.decode("utf-8")
        elif f == 2 and wt == 2:
            raw = v
        elif f == 4 and wt == 2:
            content_type = v.decode("utf-8")
    return api_version, kind, raw, content_type


def encode_unknown(api_version: str, kind: str, raw: bytes,
                   content_type: str = "") -> bytes:
    type_meta = _ld(1, api_version.encode()) + _ld(2, kind.encode())
    out = _ld(1, type_meta) + _ld(2, raw)
    if content_type:
        out += _ld(4, content_type.encode())
    return K8S_MAGIC + out


def object_meta(obj_raw: bytes) -> tuple:
    """(namespace, name) from a serialized object's ObjectMeta (field 1;
    name=1, namespace=3 per meta/v1 generated.proto)."""
    meta = field_bytes(obj_raw, 1)
    if meta is None:
        return "", ""
    name = namespace = ""
    for f, wt, _, _, v in records(meta):
        if f == 1 and wt == 2:
            name = v.decode("utf-8")
        elif f == 3 and wt == 2:
            namespace = v.decode("utf-8")
    return namespace, name


def filter_list_raw(raw: bytes,
                    is_allowed: Callable[[str, str], bool]) -> bytes:
    """Drop disallowed `items` (field 2) records by byte-splicing; all other
    fields (ListMeta, unknown extensions) are copied verbatim."""
    out = bytearray()
    for f, wt, start, end, v in records(raw):
        if f == 2 and wt == 2:
            namespace, name = object_meta(v)
            if not is_allowed(namespace, name):
                continue
        out += raw[start:end]
    return bytes(out)


def iter_list_items(raw: bytes) -> Iterator[bytes]:
    for f, wt, _, _, v in records(raw):
        if f == 2 and wt == 2:
            yield v


# -- Table support ------------------------------------------------------------
# meta/v1 Table: { ListMeta metadata=1; columnDefinitions=2; rows=3 }
# TableRow:      { cells(RawExtension)=1; conditions=2; object(RawExtension)=3 }
# RawExtension:  { bytes raw = 1 }  (the object raw is itself `k8s\x00`+Unknown
# for proto-negotiated tables)

def _table_row_meta(row: bytes) -> tuple:
    obj_ext = field_bytes(row, 3)
    if obj_ext is None:
        return "", ""
    obj_raw = field_bytes(obj_ext, 1)
    if obj_raw is None:
        return "", ""
    if obj_raw.startswith(K8S_MAGIC):
        _, _, obj_raw, _ = decode_unknown(obj_raw)
    return object_meta(obj_raw)


def filter_table_raw(raw: bytes,
                     is_allowed: Callable[[str, str], bool]) -> bytes:
    """Drop disallowed Table rows (field 3) by byte-splicing."""
    out = bytearray()
    for f, wt, start, end, v in records(raw):
        if f == 3 and wt == 2:
            namespace, name = _table_row_meta(v)
            if not is_allowed(namespace, name):
                continue
        out += raw[start:end]
    return bytes(out)


# -- watch stream support -----------------------------------------------------
# Protobuf watch streams are length-delimited frames (4-byte big-endian
# length prefix, k8s.io/apimachinery/pkg/util/framer); each payload is a
# RAW-serialized metav1.WatchEvent { type = 1; object(RawExtension) = 2 }
# whose object.raw is a full `k8s\x00` envelope (the apiserver's embedded
# watch encoder re-envelopes the object with the negotiated serializer).
# The reference decodes these via its negotiated streaming codec
# (responsefilterer.go:500-506); this is the wire-level equivalent.

def decode_watch_event(payload: bytes) -> tuple:
    """(event_type, api_version, kind, obj_raw) from a raw-serialized
    metav1.WatchEvent payload (no length prefix, no envelope).  The embedded
    object's `k8s\\x00` envelope is stripped when present so `obj_raw` is
    directly usable with object_meta()."""
    event_type = ""
    obj_raw = b""
    api_version = kind = ""
    for f, wt, _, _, v in records(payload):
        if f == 1 and wt == 2:
            event_type = v.decode("utf-8")
        elif f == 2 and wt == 2:
            obj_raw = field_bytes(v, 1) or b""
    if obj_raw.startswith(K8S_MAGIC):
        api_version, kind, obj_raw, _ = decode_unknown(obj_raw)
    return event_type, api_version, kind, obj_raw


def table_first_row_meta(table_raw: bytes) -> tuple:
    """(namespace, name) of the first row's object in a serialized
    meta/v1 Table (watch Table events carry one row per event)."""
    for f, wt, _, _, v in records(table_raw):
        if f == 3 and wt == 2:
            return _table_row_meta(v)
    return "", ""


def encode_watch_event(event_type: str, obj_envelope: bytes) -> bytes:
    """A framed watch event (4-byte length prefix included) for the fake
    apiserver / tests.  `obj_envelope` is a full `k8s\\x00` envelope."""
    payload = _ld(1, event_type.encode()) + _ld(2, _ld(1, obj_envelope))
    return len(payload).to_bytes(4, "big") + payload


# -- encode helpers (used by the fake apiserver to SERVE protobuf) ------------

def encode_object_meta(name: str, namespace: str = "",
                       extra_json: Optional[dict] = None) -> bytes:
    out = _ld(1, name.encode())
    if namespace:
        out += _ld(3, namespace.encode())
    return out


def encode_object(api_version: str, kind: str, name: str,
                  namespace: str = "") -> bytes:
    """A minimal serialized object: just ObjectMeta (field 1)."""
    return _ld(1, encode_object_meta(name, namespace))


def encode_list(api_version: str, kind: str, items: list) -> bytes:
    """items: serialized object payloads (encode_object outputs)."""
    raw = _ld(1, b"")  # empty ListMeta
    for item in items:
        raw += _ld(2, item)
    return encode_unknown(api_version, kind, raw,
                          "application/vnd.kubernetes.protobuf")


def encode_table(row_objects: list) -> bytes:
    """A serialized meta/v1 Table envelope.  `row_objects` are the per-row
    object payloads — either plain serialized objects or full `k8s\\x00`
    envelopes (the real apiserver nests envelopes; _table_row_meta handles
    both).  Each becomes rows[i].object.raw (RawExtension field 1)."""
    raw = _ld(1, b"")  # empty ListMeta
    for obj in row_objects:
        raw += _ld(3, _ld(3, _ld(1, obj)))  # row{ object{ raw } }
    return encode_unknown("meta.k8s.io/v1", "Table", raw,
                          "application/vnd.kubernetes.protobuf")
