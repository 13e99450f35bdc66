"""The port's authzed.api.v1 wire codecs held against the reference's.

Seeded random messages of every type in wire.py's field table go
through both packages' encoders: the bytes are identical.  Each
package's decoders read the other's bytes into equal objects, and the
literal golden fixtures of tests/test_wire_golden.py (hand-assembled
from the public field numbers) and its real-protobuf messages decode on
the port's codec as on the reference's.  Tolerance: exact equality.
"""

import numpy as np
import pytest

import spicedb_kubeapi_proxy_tpu.spicedb.types as RT
import spicedb_kubeapi_proxy_tpu.spicedb.wire as RW
import spicedb_kubeapi_proxy_tpu_torch.spicedb.types as PT
import spicedb_kubeapi_proxy_tpu_torch.spicedb.wire as PW

SEEDS = list(range(12))


def _gen(seed: int):
    """A seeded message generator: the same draws build the same value
    in either package's types (`T`)."""
    rng = np.random.default_rng(seed)

    def word(n=8):
        alphabet = "abcdefghijklmnopqrstuvwxyz0123456789-_/"
        k = int(rng.integers(1, n + 1))
        return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), k))

    def ctx_value(depth=0):
        kind = int(rng.integers(0, 6 if depth < 2 else 4))
        if kind == 0:
            return None
        if kind == 1:
            return bool(rng.integers(0, 2))
        if kind == 2:
            return (int(rng.integers(-1000, 1000)) if rng.integers(0, 2)
                    else float(rng.integers(-1000, 1000)) + 0.25)
        if kind == 3:
            return word()
        if kind == 4:
            return {word(4): ctx_value(depth + 1)
                    for _ in range(int(rng.integers(0, 3)))}
        return [ctx_value(depth + 1) for _ in range(int(rng.integers(0, 3)))]

    def draw():
        """One plain description of every message kind (no package
        types), from which `build(T, d)` makes the objects."""
        def rel():
            cav = None
            if rng.integers(0, 2):
                ctx = ({word(5): ctx_value() for _ in
                        range(int(rng.integers(1, 4)))}
                       if rng.integers(0, 2) else None)
                cav = (word(6), ctx)
            exp = (float(rng.integers(1_700_000_000, 1_800_000_000))
                   + float(rng.integers(0, 1000)) / 1000
                   if rng.integers(0, 2) else None)
            return (word(), word(), word(), word(), word(),
                    word() if rng.integers(0, 2) else "", cav, exp)

        def subj():
            return (word(), word(), word() if rng.integers(0, 2) else "")

        def flt():
            sub = None
            if rng.integers(0, 2):
                sub = (word(), word() if rng.integers(0, 2) else "",
                       [None, "", word()][int(rng.integers(0, 3))])
            return (word(), word() if rng.integers(0, 2) else "",
                    word() if rng.integers(0, 2) else "", sub)

        return {
            "rels": [rel() for _ in range(int(rng.integers(1, 5)))],
            "ops": [int(rng.integers(0, 3)) for _ in range(5)],
            "pre": [(int(rng.integers(0, 2)), flt())
                    for _ in range(int(rng.integers(0, 3)))],
            "checks": [((word(), word()), word(), subj())
                       for _ in range(int(rng.integers(1, 6)))],
            "ships": [int(rng.integers(0, 3)) for _ in range(6)],
            "rev": int(rng.integers(0, 1 << 40)),
            "flt": flt(),
            "types": [word() for _ in range(int(rng.integers(0, 3)))],
            "lookup": (word(), word(), subj(), word()),
        }

    return draw()


def build(T, d):
    def rel(r):
        cav = T.CaveatRef.make(r[6][0], r[6][1]) if r[6] else None
        return T.Relationship(T.ObjectRef(r[0], r[1]), r[2],
                              T.SubjectRef(r[3], r[4], r[5]),
                              caveat=cav, expires_at=r[7])

    def flt(f):
        sub = (T.SubjectFilter(type=f[3][0], id=f[3][1], relation=f[3][2])
               if f[3] else None)
        return T.RelationshipFilter(resource_type=f[0], resource_id=f[1],
                                    relation=f[2], subject=sub)

    ops = [T.UpdateOp.CREATE, T.UpdateOp.TOUCH, T.UpdateOp.DELETE]
    ships = [T.Permissionship.NO_PERMISSION, T.Permissionship.HAS_PERMISSION,
             T.Permissionship.CONDITIONAL_PERMISSION]
    pre_ops = [T.PreconditionOp.MUST_NOT_MATCH, T.PreconditionOp.MUST_MATCH]
    rels = [rel(r) for r in d["rels"]]
    checks = [T.CheckRequest(T.ObjectRef(*c[0]), c[1], T.SubjectRef(*c[2]))
              for c in d["checks"]]
    return {
        "rels": rels,
        "updates": [T.RelationshipUpdate(ops[d["ops"][i % 5]], r)
                    for i, r in enumerate(rels)],
        "pre": [T.Precondition(op=pre_ops[o], filter=flt(f))
                for o, f in d["pre"]],
        "checks": checks,
        "results": [T.CheckResult(permissionship=ships[d["ships"][i % 6]],
                                  checked_at=d["rev"])
                    for i in range(len(checks))],
        "rev": d["rev"],
        "flt": flt(d["flt"]),
        "types": d["types"],
        "lookup": (d["lookup"][0], d["lookup"][1],
                   T.SubjectRef(*d["lookup"][2]), d["lookup"][3]),
    }


def encodings(W, m):
    """Every encoder of wire.py on the message set `m`: name -> bytes."""
    rt, perm, subj, rid = m["lookup"]
    out = {
        "object": W.enc_object(m["checks"][0].resource),
        "subject": W.enc_subject(m["checks"][0].subject),
        "zedtoken": W.enc_zedtoken(m["rev"]),
        "consistency": W.enc_consistency_full(),
        "rel_filter": W.enc_rel_filter(m["flt"]),
        "check_request": W.enc_check_request(m["checks"][0]),
        "check_response": W.enc_check_response(m["results"][0]),
        "bulk_request": W.enc_bulk_request(m["checks"]),
        "bulk_response": W.enc_bulk_response(m["rev"], m["results"]),
        "lookup_request": W.enc_lookup_request(rt, perm, subj),
        "lookup_response": W.enc_lookup_response(m["rev"], rid),
        "read_request": W.enc_read_request(m["flt"]),
        "read_request_all": W.enc_read_request(None),
        "write_request": W.enc_write_request(m["updates"], m["pre"]),
        "write_response": W.enc_write_response(m["rev"]),
        "delete_request": W.enc_delete_request(m["flt"], m["pre"]),
        "delete_response": W.enc_delete_response(m["rev"]),
        "watch_request": W.enc_watch_request(m["types"]),
        "watch_response": W.enc_watch_response(m["rev"], m["updates"]),
    }
    for i, r in enumerate(m["rels"]):
        out[f"relationship{i}"] = W.enc_relationship(r)
        out[f"read_response{i}"] = W.enc_read_response(m["rev"], r)
    for i, u in enumerate(m["updates"]):
        out[f"update{i}"] = W.enc_update(u)
    for i, p in enumerate(m["pre"]):
        out[f"precondition{i}"] = W.enc_precondition(p)
    return out


_DECODERS = {
    "object": "dec_object", "subject": "dec_subject",
    "rel_filter": "dec_rel_filter", "check_request": "dec_check_request",
    "check_response": "dec_check_response", "bulk_request": "dec_bulk_request",
    "bulk_response": "dec_bulk_response",
    "lookup_request": "dec_lookup_request",
    "lookup_response": "dec_lookup_response",
    "read_request": "dec_read_request", "read_request_all": "dec_read_request",
    "write_request": "dec_write_request",
    "write_response": "dec_write_response",
    "delete_request": "dec_delete_request",
    "delete_response": "dec_delete_response",
    "watch_request": "dec_watch_request",
    "watch_response": "dec_watch_response",
}


def _decoder(name: str) -> str:
    for prefix, dec in (("relationship", "dec_relationship"),
                        ("read_response", "dec_read_response"),
                        ("update", "dec_update"),
                        ("precondition", "dec_precondition")):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return dec
    return _DECODERS.get(name, "")


def canon(x):
    """A package-free form of a decoded value: enums by name, dataclasses
    and tuples as tuples, caveats by name and context."""
    import dataclasses
    import enum
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name)
    if hasattr(x, "context") and hasattr(x, "name") and callable(x.context):
        return ("caveat", x.name, canon(x.context()))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            canon(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, canon(v)) for k, v in x.items()))
    return x


@pytest.mark.parametrize("seed", SEEDS)
def test_every_encoder_gives_the_reference_bytes(seed):
    d = _gen(seed)
    got = encodings(PW, build(PT, d))
    want = encodings(RW, build(RT, d))
    assert got.keys() == want.keys()
    for name in got:
        assert got[name] == want[name], name


@pytest.mark.parametrize("seed", SEEDS)
def test_each_package_decodes_the_others_bytes(seed):
    d = _gen(seed)
    port_bytes = encodings(PW, build(PT, d))
    ref_bytes = encodings(RW, build(RT, d))
    decoded = 0
    for name, raw in port_bytes.items():
        dec = _decoder(name)
        if not dec:
            continue
        a = canon(getattr(RW, dec)(raw))
        b = canon(getattr(PW, dec)(ref_bytes[name]))
        assert a == b == canon(getattr(PW, dec)(raw)), name
        decoded += 1
    assert decoded >= 17


def test_zedtoken_and_fields_edge_cases_match():
    for raw in (None, b"", PW.enc_zedtoken(0), PW.enc_zedtoken(1 << 62),
                PW._str_field(1, "not-a-number")):
        assert PW.dec_zedtoken(raw) == RW.dec_zedtoken(raw)
    for v in (0, 1, 127, 128, 300, 1 << 35, (1 << 64) - 1):
        assert PW._varint(v) == RW._varint(v)
        assert PW._read_varint(PW._varint(v), 0) == RW._read_varint(
            RW._varint(v), 0)
    blob = PW.enc_watch_response(7, [])
    assert list(PW.fields(blob)) == list(RW.fields(blob))
    with pytest.raises(ValueError):
        list(PW.fields(bytes([0x0B])))          # wire type 3


# -- the reference's golden fixtures on the port's codec ---------------------

golden = pytest.importorskip("test_wire_golden")


def test_golden_literals_decode_on_the_port():
    g = golden
    subj = PT.SubjectRef(g.SUBJ.type, g.SUBJ.id, g.SUBJ.relation)
    assert PW.enc_check_request(PT.CheckRequest(
        PT.ObjectRef("pod", "ns1/p0"), "view", subj)) == g.GOLDEN_CHECK_REQ
    req = PW.dec_check_request(g.GOLDEN_CHECK_REQ)
    assert (req.resource, req.permission) == (PT.ObjectRef("pod", "ns1/p0"),
                                              "view")
    res = PW.dec_check_response(g.GOLDEN_CHECK_RESP)
    assert (res.permissionship, res.checked_at) == (
        PT.Permissionship.HAS_PERMISSION, 42)
    updates, pre = PW.dec_write_request(g.GOLDEN_WRITE_REQ)
    assert not pre and updates[0].op == PT.UpdateOp.TOUCH
    assert canon(updates[0].rel) == canon(g.REL)
    assert PW.dec_lookup_request(g.GOLDEN_LOOKUP_REQ)[:2] == ("pod", "view")
    assert PW.dec_lookup_response(g.GOLDEN_LOOKUP_RESP) == (
        "ns1/p0", PT.Permissionship.HAS_PERMISSION)
    items = PW.dec_bulk_request(g.GOLDEN_BULK_REQ)
    assert [canon(i) for i in items] == [
        canon(i) for i in RW.dec_bulk_request(g.GOLDEN_BULK_REQ)]
    for name in dir(g):
        if name.startswith("GOLDEN_"):
            raw = getattr(g, name)
            assert list(PW.fields(raw)) == list(RW.fields(raw)), name


def test_real_protobuf_messages_decode_on_the_port():
    """Messages built by the real protobuf runtime (the golden test's
    dynamic authzed.api.v1 mirror) decode on the port as on the
    reference, caveat context and expiry included."""
    A = golden.A
    m = A["WriteRelationshipsRequest"]()
    u = m.updates.add()
    u.operation = 2
    r = u.relationship
    r.resource.object_type, r.resource.object_id = "doc", "d1"
    r.relation = "viewer"
    r.subject.object.object_type, r.subject.object.object_id = "user", "a"
    r.optional_caveat.caveat_name = "on_call"
    f = r.optional_caveat.context.fields.add()
    f.key = "active"
    f.value.bool_value = False
    r.optional_expires_at.seconds = 1_750_000_000
    r.optional_expires_at.nanos = 500_000_000
    p = m.optional_preconditions.add()
    p.operation = 1
    p.filter.resource_type = "doc"
    raw = m.SerializeToString()
    assert canon(PW.dec_write_request(raw)) == canon(RW.dec_write_request(raw))
    got = PW.dec_write_request(raw)[0][0].rel
    assert got.caveat.context() == {"active": False}
    assert got.expires_at == 1_750_000_000.5
