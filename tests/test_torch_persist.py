"""The port's durable store held against the reference's.

Every case of tests/test_persist.py — WAL framing, segment rolling and
the checkpoint cut, torn-tail repair, mid-stream and sealed-segment
corruption, torn segment headers, the idle fsync hook, recovery parity
of a mixed update stream (WAL only, checkpoint plus tail with reclaim,
delete_all and object-path bulk loads, object-path checkpoints, revision
continuity, the rev-1 checkpoint with an overlay), the fail-stop after a
failed append, the sidecar-before-record order, bootstrap-once, the
checkpoint crash windows and the CLI wiring — runs on the port's
modules, and where a case observes state (read-sets, revisions, recovery
counters, WAL records) the reference's modules run it too and the two
must be equal.

Across packages: the same update stream journaled by both packages
gives equal decoded WAL records, equal segment bytes, equal manifest
revisions and watermarks, and equal checkpoint columns; and a data dir
written by either package recovers in the other to the same read-set,
revision and recovery counters — the move between a `jax://` and a
`torch://` deployment on one volume.
"""

import glob
import importlib
import json
import os
import tempfile

import numpy as np
import pytest

from test_persist import BOOT, SCHEMA


class PPkg:
    """The modules of one package that a durable-store case needs."""

    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.persist = mod("spicedb.persist")
        self.wal = mod("spicedb.persist.wal")
        self.checkpoint = mod("spicedb.persist.checkpoint")
        self.store = mod("spicedb.store")
        self.types = mod("spicedb.types")
        self.endpoints = mod("spicedb.endpoints")
        self.failpoints = mod("utils.failpoints")
        self.cli = mod("cli")

    def touch(self, s):
        t = self.types
        return t.RelationshipUpdate(t.UpdateOp.TOUCH, t.parse_relationship(s))

    def delete(self, s):
        t = self.types
        return t.RelationshipUpdate(t.UpdateOp.DELETE,
                                    t.parse_relationship(s))

    def caveated(self, rid, user, context=None, expires_at=None):
        t = self.types
        caveat = (t.CaveatRef.make("tod", context) if context is not None
                  else t.CaveatRef.make("tod"))
        return t.Relationship(resource=t.ObjectRef("doc", rid),
                              relation="viewer",
                              subject=t.SubjectRef("user", user),
                              caveat=caveat, expires_at=expires_at)


REF = PPkg("spicedb_kubeapi_proxy_tpu")
PORT = PPkg("spicedb_kubeapi_proxy_tpu_torch")
BOTH = [PORT, REF]


@pytest.fixture(autouse=True)
def reset_failpoints():
    for P in BOTH:
        P.failpoints.disable_all()
    yield
    for P in BOTH:
        P.failpoints.disable_all()


@pytest.fixture()
def tmpdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def rels_of(store):
    return sorted(r.rel_string() for r in store.read(None))


def sub(tmpdir, P):
    d = os.path.join(tmpdir, P.root)
    os.makedirs(d, exist_ok=True)
    return d


def info_of(mgr) -> dict:
    """recovery_info without its wall-clock timings."""
    return {k: v for k, v in mgr.recovery_info.items()
            if not k.endswith("_s")}


# -- the WAL ---------------------------------------------------------------

def test_append_replay_round_trip(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        wal = P.wal.SegmentedWal(d, fsync="never")
        for i in range(1, 8):
            wal.append(b'{"k":"c","r":%d}' % i)
        wal.close()
        got = [rec["r"] for rec in P.wal.SegmentedWal(d).replay()]
        assert got == list(range(1, 8))
        out.append((got, open(glob.glob(os.path.join(d, "seg-*.wal"))[0],
                              "rb").read()))
    assert out[0] == out[1]


def test_segment_rolling_and_cut(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        wal = P.wal.SegmentedWal(d, fsync="never", segment_bytes=64)
        for i in range(1, 11):
            wal.append(b'{"k":"c","r":%d}' % i)
        assert wal.segment_count() > 1
        watermark = wal.cut()
        wal.append(b'{"k":"c","r":11}')
        assert max(wal.segment_seqs()) > watermark
        got = [rec["r"] for rec in P.wal.SegmentedWal(d).replay()]
        assert got == list(range(1, 12))
        out.append((watermark, wal.segment_seqs(), got))
    assert out[0] == out[1]


def test_torn_tail_truncated(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        wal = P.wal.SegmentedWal(d, fsync="never")
        for i in range(1, 6):
            wal.append(b'{"k":"c","r":%d}' % i)
        wal.close()
        seg = sorted(glob.glob(os.path.join(d, "seg-*.wal")))[-1]
        with open(seg, "rb+") as f:
            f.truncate(os.path.getsize(seg) - 5)
        reader = P.wal.SegmentedWal(d)
        got = [rec["r"] for rec in reader.replay()]
        assert got == [1, 2, 3, 4]
        assert reader.torn_records == 1
        assert [r["r"] for r in P.wal.SegmentedWal(d).replay()] == got
        out.append((got, os.path.getsize(seg)))
    assert out[0] == out[1]


def test_mid_segment_corruption_raises(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        wal = P.wal.SegmentedWal(d, fsync="never")
        for i in range(1, 6):
            wal.append(b'{"k":"c","r":%d}' % i)
        wal.close()
        seg = sorted(glob.glob(os.path.join(d, "seg-*.wal")))[-1]
        with open(seg, "rb+") as f:
            f.seek(20)
            f.write(b"\xff")
        with pytest.raises(P.wal.WalCorruptionError):
            list(P.wal.SegmentedWal(d).replay())


def test_sealed_segment_corruption_raises_even_at_its_tail(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        wal = P.wal.SegmentedWal(d, fsync="never", segment_bytes=32)
        for i in range(1, 6):
            wal.append(b'{"k":"c","r":%d}' % i)
        wal.close()
        segs = sorted(glob.glob(os.path.join(d, "seg-*.wal")))
        assert len(segs) > 1
        with open(segs[0], "rb+") as f:
            f.truncate(os.path.getsize(segs[0]) - 3)
        with pytest.raises(P.wal.WalCorruptionError):
            list(P.wal.SegmentedWal(d).replay())


def test_bad_fsync_policy_rejected(tmpdir):
    with pytest.raises(ValueError, match="unknown fsync policy"):
        PORT.wal.SegmentedWal(tmpdir, fsync="sometimes")


def test_torn_segment_header_survives_two_restarts(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        wal = P.wal.SegmentedWal(d, fsync="never")
        for i in range(1, 4):
            wal.append(b'{"k":"c","r":%d}' % i)
        wal.close()
        segs = sorted(glob.glob(os.path.join(d, "seg-*.wal")))
        torn = os.path.join(d, "seg-%08d.wal" % (len(segs) + 1))
        with open(torn, "wb") as f:
            f.write(b"SPW")
        w2 = P.wal.SegmentedWal(d)
        assert [r["r"] for r in w2.replay()] == [1, 2, 3]
        assert not os.path.exists(torn)
        w2.append(b'{"k":"c","r":4}')
        w2.close()
        assert [r["r"] for r in P.wal.SegmentedWal(d).replay()] == \
            [1, 2, 3, 4]


def test_empty_segment_tolerated_mid_stream(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        wal = P.wal.SegmentedWal(d, fsync="never")
        wal.append(b'{"k":"c","r":1}')
        wal.close()
        open(os.path.join(d, "seg-00000002.wal"), "wb").close()
        w2 = P.wal.SegmentedWal(d)
        w2.append(b'{"k":"c","r":2}')
        w2.close()
        assert [r["r"] for r in P.wal.SegmentedWal(d).replay()] == [1, 2]


def test_idle_fsync_hook(tmpdir):
    wal = PORT.wal.SegmentedWal(tmpdir, fsync="interval",
                                fsync_interval=3600)
    wal.append(b'{"k":"c","r":1}')
    assert wal.fsync_if_dirty() is True
    assert wal.fsync_if_dirty() is False


# -- recovery parity ---------------------------------------------------------

def drive(P, store):
    """The reference test's deterministic mixed update stream."""
    store.bulk_load_text(BOOT)
    for i in range(12):
        store.write([P.touch(f"doc:w{i}#viewer@user:u{i % 3}")])
    store.write([P.delete("doc:w5#viewer@user:u2"),
                 P.touch("doc:extra#viewer@user:u1")])
    store.delete_by_filter(P.types.RelationshipFilter(resource_id="w7"))
    store.write([])
    store.write([P.types.RelationshipUpdate(
        P.types.UpdateOp.TOUCH,
        P.caveated("cav", "u9", {"x": 1}, expires_at=88888888888.0))])


def test_wal_only_recovery(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        assert not mgr.recovered and store.revision == 0
        mgr.attach(store)
        drive(P, store)
        want, rev = rels_of(store), store.revision
        mgr2 = P.persist.PersistenceManager(d)
        s2 = mgr2.recover()
        assert mgr2.recovered
        assert (s2.revision, rels_of(s2)) == (rev, want)
        assert any("[caveat:tod:" in r for r in rels_of(s2))
        out.append((rev, want, info_of(mgr2)))
    assert out[0] == out[1]


def test_checkpoint_plus_tail_and_reclaim(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never",
                                           segment_bytes=256)
        store = mgr.recover()
        mgr.attach(store)
        drive(P, store)
        pre_segments = mgr.wal.segment_count()
        manifest = mgr.checkpoint()
        assert manifest["revision"] == store.revision
        assert mgr.wal.segment_count() < pre_segments
        assert mgr.checkpoint() is None
        store.write([P.touch("doc:tail#viewer@user:u1")])
        want, rev = rels_of(store), store.revision
        mgr2 = P.persist.PersistenceManager(d)
        s2 = mgr2.recover()
        info = mgr2.recovery_info
        assert info["checkpoint_revision"] == manifest["revision"]
        assert info["replayed_records"] == 1
        assert (s2.revision, rels_of(s2)) == (rev, want)
        out.append((pre_segments, manifest["revision"],
                    manifest["watermark"], mgr.wal.segment_seqs(), rev,
                    want, info_of(mgr2)))
    assert out[0] == out[1]


def test_delete_all_and_object_path_bulk_survive(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        store.bulk_load_text(BOOT)
        store.delete_all()
        store.bulk_load([P.types.parse_relationship(
            "doc:obj#viewer@user:u4")])
        want, rev = rels_of(store), store.revision
        s2 = P.persist.PersistenceManager(d).recover()
        assert (rels_of(s2), s2.revision) == (want, rev)
        assert rels_of(s2) == ["doc:obj#viewer@user:u4"]
        out.append((want, rev))
    assert out[0] == out[1]


def test_object_path_checkpoint(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        store.write([P.touch("doc:a#viewer@user:u1"),
                     P.touch("doc:b#viewer@user:u2")])
        store.write([P.types.RelationshipUpdate(
            P.types.UpdateOp.TOUCH, P.caveated("c", "u3"))])
        mgr.checkpoint()
        want, rev = rels_of(store), store.revision
        s2 = P.persist.PersistenceManager(d).recover()
        assert (rels_of(s2), s2.revision) == (want, rev)
        out.append((want, rev))
    assert out[0] == out[1]


def test_revision_continuity_after_recovery(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        drive(P, store)
        rev = store.revision
        mgr2 = P.persist.PersistenceManager(d)
        s2 = mgr2.recover()
        mgr2.attach(s2)
        assert s2.write([P.touch("doc:post#viewer@user:u1")]) == rev + 1


def test_adopt_recovery_state_guards():
    store = PORT.store.TupleStore()
    with pytest.raises(ValueError):
        store.adopt_recovery_state(None, [], 0)
    store.adopt_recovery_state(
        None, [PORT.types.parse_relationship("doc:a#viewer@user:u1")], 7)
    assert store.revision == 7
    assert rels_of(store) == ["doc:a#viewer@user:u1"]
    with pytest.raises(ValueError):
        store.adopt_recovery_state(None, [], 9)


def test_wal_append_failure_fail_stops_untouched(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        store.write([P.touch("doc:a#viewer@user:u1")])
        real_append = mgr.wal.append

        def flaky_append(payload, kind=""):
            raise OSError("disk on fire")
        mgr.wal.append = flaky_append
        with pytest.raises(OSError):
            store.write([P.touch("doc:b#viewer@user:u1")])
        assert store.revision == 1
        assert rels_of(store) == ["doc:a#viewer@user:u1"]
        mgr.wal.append = real_append
        with pytest.raises(P.persist.PersistenceUnavailableError):
            store.write([P.touch("doc:c#viewer@user:u1")])
        ck = mgr.checkpoint()
        assert ck is not None and ck["revision"] == 1
        s2 = P.persist.PersistenceManager(d).recover()
        assert s2.revision == 1
        assert rels_of(s2) == ["doc:a#viewer@user:u1"]
        out.append((s2.revision, rels_of(s2)))
    assert out[0] == out[1]


def test_rev1_checkpoint_with_overlay_recovers(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        store.bulk_load([
            P.types.parse_relationship("doc:plain#viewer@user:u1"),
            P.caveated("cav", "u2", {"x": 1})])
        assert store.revision == 1
        mgr.checkpoint()
        mgr.close()
        for _ in range(2):
            s2 = P.persist.PersistenceManager(d).recover()
            assert s2.revision == 1
            assert rels_of(s2) == rels_of(store)


def test_sidecar_written_before_record(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        store.bulk_load_text(BOOT)
        snaps = [r for r in mgr.wal.replay() if r["k"] == "s"]
        assert snaps
        for r in snaps:
            assert os.path.exists(os.path.join(mgr.wal.dir, r["f"]))


# -- bootstrap-once ------------------------------------------------------------

@pytest.mark.parametrize("url", ["embedded://", "torch://?device=cpu"])
def test_restart_does_not_double_apply_bootstrap(tmpdir, url):
    P = PORT
    boot = P.endpoints.Bootstrap(schema_text=SCHEMA, relationships_text=BOOT)
    mgr = P.persist.PersistenceManager(tmpdir, fsync="never")
    store = mgr.recover()
    mgr.attach(store)
    P.endpoints.create_endpoint(url, bootstrap=boot, store=store)
    assert store.revision > 0
    store.write([P.touch("doc:post#viewer@user:u1")])
    rev, want = store.revision, rels_of(store)
    mgr2 = P.persist.PersistenceManager(tmpdir)
    s2 = mgr2.recover()
    mgr2.attach(s2)
    ep2 = P.endpoints.create_endpoint(url, bootstrap=boot, store=s2)
    assert s2.revision == rev
    assert rels_of(s2) == want
    assert ep2.store is s2


def test_fresh_store_still_bootstraps():
    ep = PORT.endpoints.EmbeddedEndpoint.from_bootstrap(
        PORT.endpoints.Bootstrap(schema_text=SCHEMA, relationships_text=BOOT))
    assert ep.store.count() == 3


def test_store_kwarg_rejected_for_unserved_scheme():
    # the reference refuses a store for its remote grpc:// endpoint; the
    # port serves no remote endpoint at all
    with pytest.raises(PORT.endpoints.EndpointConfigError):
        PORT.endpoints.create_endpoint("grpc://localhost:50051",
                                       store=PORT.store.TupleStore())


# -- checkpoint crash windows --------------------------------------------------

def test_checkpoint_rename_crash_keeps_old_state(tmpdir):
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        store.bulk_load_text(BOOT)
        store.write([P.touch("doc:one#viewer@user:u1")])
        want, rev = rels_of(store), store.revision
        P.failpoints.enable_failpoint("checkpointBeforeRename", 1)
        with pytest.raises(P.failpoints.FailPointPanic):
            mgr.checkpoint()
        s2 = P.persist.PersistenceManager(d).recover()
        assert (rels_of(s2), s2.revision) == (want, rev)


def test_manifest_rename_crash_keeps_old_manifest(tmpdir):
    out = []
    for P in BOTH:
        d = sub(tmpdir, P)
        mgr = P.persist.PersistenceManager(d, fsync="never")
        store = mgr.recover()
        mgr.attach(store)
        store.bulk_load_text(BOOT)
        first = mgr.checkpoint()
        store.write([P.touch("doc:two#viewer@user:u2")])
        want, rev = rels_of(store), store.revision
        P.failpoints.enable_failpoint("manifestBeforeRename", 1)
        with pytest.raises(P.failpoints.FailPointPanic):
            mgr.checkpoint()
        mgr2 = P.persist.PersistenceManager(d)
        s2 = mgr2.recover()
        assert mgr2.recovery_info["checkpoint_revision"] == first["revision"]
        assert (rels_of(s2), s2.revision) == (want, rev)
        out.append((first["revision"], want, rev, info_of(mgr2)))
    assert out[0] == out[1]


# -- CLI wiring ------------------------------------------------------------------

def _args(P, *extra):
    return P.cli.build_parser().parse_args([
        "--backend-kubeconfig", "x", "--rule-config", "y", *extra])


def test_cli_flags_parse():
    for P in BOTH:
        args = _args(P, "--data-dir", "/tmp/dd", "--wal-fsync", "always",
                     "--checkpoint-interval", "60")
        assert (args.data_dir, args.wal_fsync, args.checkpoint_interval) == \
            ("/tmp/dd", "always", 60.0)
    assert PORT.cli.validate(_args(PORT, "--data-dir", "/tmp/dd")) == []


def test_cli_defaults():
    args = _args(PORT)
    assert (args.data_dir, args.wal_fsync, args.checkpoint_interval) == \
        ("", "interval", 300.0)


def test_cli_data_dir_requires_store_backed_endpoint():
    args = _args(PORT, "--data-dir", "/tmp/dd",
                 "--spicedb-endpoint", "grpc://h:1")
    assert ("--data-dir persistence requires a store-backed endpoint "
            "(embedded:// or torch://)") in PORT.cli.validate(args)


def test_cli_checkpoint_interval_positive():
    errs = PORT.cli.validate(_args(PORT, "--checkpoint-interval", "0"))
    ref_errs = REF.cli.validate(_args(REF, "--checkpoint-interval", "0"))
    assert "--checkpoint-interval must be > 0" in errs
    assert "--checkpoint-interval must be > 0" in ref_errs


def test_cli_bad_fsync_choice_rejected():
    with pytest.raises(SystemExit):
        _args(PORT, "--wal-fsync", "sometimes")


def test_cli_workflow_db_defaults_into_data_dir(tmpdir):
    cli = PORT.cli
    dd = os.path.join(tmpdir, "data")
    assert cli.resolve_workflow_db(dd, cli.DEFAULT_WORKFLOW_DATABASE_PATH) \
        == os.path.join(dd, "dtx.sqlite")
    assert os.path.isdir(dd)
    assert cli.resolve_workflow_db(dd, "/elsewhere.sqlite") == \
        "/elsewhere.sqlite"
    assert cli.resolve_workflow_db("", cli.DEFAULT_WORKFLOW_DATABASE_PATH) \
        == cli.DEFAULT_WORKFLOW_DATABASE_PATH
    assert cli.DEFAULT_WORKFLOW_DATABASE_PATH == \
        REF.cli.DEFAULT_WORKFLOW_DATABASE_PATH


# -- data dirs across packages ---------------------------------------------------

def journal(P, d):
    """Journal the test stream into data dir `d` with one package: the
    mixed stream, a checkpoint, then a tail.  Returns the live store."""
    mgr = P.persist.PersistenceManager(d, fsync="always", segment_bytes=512)
    store = mgr.recover()
    mgr.attach(store)
    drive(P, store)
    mgr.checkpoint()
    store.write([P.touch("doc:tail#viewer@user:u2"),
                 P.delete("doc:w3#viewer@user:u0")])
    store.write([P.types.RelationshipUpdate(
        P.types.UpdateOp.TOUCH,
        P.types.parse_relationship(
            "doc:later#viewer@user:u1[expiration:99999999999]"))])
    return store


def _ckpt_contents(P, d):
    man = P.checkpoint.read_manifest(d)
    snap, overlay, meta = P.checkpoint.load_columnar_file(
        os.path.join(d, P.checkpoint.CHECKPOINT_DIR, man["checkpoint"]))
    cols = {c: np.asarray(getattr(snap, c)).tolist()
            for c in ("rtype", "rid", "rel", "stype", "sid", "srel")}
    return ({k: man[k] for k in ("revision", "checkpoint", "watermark")},
            snap.pool, cols, np.asarray(snap.expiry).tolist(),
            sorted(r.rel_string() for r in overlay),
            {k: v for k, v in meta.items() if k != "overlay"})


def test_same_stream_gives_equal_data_dirs(tmpdir):
    """Both packages journal one stream: equal decoded WAL records, equal
    segment bytes (their framing is one format), equal manifest
    revisions and watermarks, and equal checkpoint columns, pools,
    expiries and overlays."""
    dirs = {}
    for P in BOTH:
        dirs[P.root] = d = sub(tmpdir, P)
        journal(P, d)
    port_d, ref_d = dirs[PORT.root], dirs[REF.root]
    assert list(PORT.wal.SegmentedWal(os.path.join(port_d, "wal")).replay()) \
        == list(REF.wal.SegmentedWal(os.path.join(ref_d, "wal")).replay())

    def seg_bytes(d):
        return [(os.path.basename(p), open(p, "rb").read())
                for p in sorted(glob.glob(os.path.join(d, "wal",
                                                       "seg-*.wal")))]
    assert seg_bytes(port_d) == seg_bytes(ref_d)
    nan_safe = json.dumps(_ckpt_contents(PORT, port_d), sort_keys=True)
    assert nan_safe == json.dumps(_ckpt_contents(REF, ref_d), sort_keys=True)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_data_dir_recovers_in_the_other_package(tmpdir, writer, reader):
    """A data dir written by one package recovers in the other to the
    writer's read-set, revision and expiry schedule, with the same
    recovery counters as the writer's own recovery, and journals on from
    there."""
    W = REF if writer == "reference" else PORT
    R = PORT if W is REF else REF
    d = os.path.join(tmpdir, "dd")
    live = journal(W, d)
    want = (rels_of(live), live.revision, live.expiry_schedule())
    own = W.persist.PersistenceManager(d)
    own_store = own.recover()
    mgr = R.persist.PersistenceManager(d, fsync="always")
    s2 = mgr.recover()
    assert (rels_of(s2), s2.revision, s2.expiry_schedule()) == want
    assert (rels_of(own_store), own_store.revision) == want[:2]
    assert info_of(mgr) == info_of(own)
    mgr.attach(s2)
    assert s2.write([R.touch("doc:next#viewer@user:u4")]) == want[1] + 1
    back = W.persist.PersistenceManager(d).recover()
    assert back.revision == want[1] + 1
    assert "doc:next#viewer@user:u4" in rels_of(back)


# -- the server over a data dir ------------------------------------------------

def _server_restart(P, url, d):
    """A ProxyServer on data dir `d`: bootstrap, writes, a checkpoint and
    a tail, then a second server on `d` (the first abandoned, as after a
    crash).  Returns the second server's revision, its recovery audit
    events (timings masked) and its bootstrap-skipped read-set."""
    import re
    kubefake = importlib.import_module(f"{P.root}.kubefake.apiserver")
    httpcore = importlib.import_module(f"{P.root}.proxy.httpcore")
    server = importlib.import_module(f"{P.root}.proxy.server")

    def make():
        return server.ProxyServer(server.Options(
            spicedb_endpoint=url,
            bootstrap=P.endpoints.Bootstrap(schema_text=SCHEMA,
                                            relationships_text=BOOT),
            upstream_transport=httpcore.HandlerTransport(
                kubefake.FakeKubeApiServer()),
            data_dir=d, wal_fsync="always", audit_level="Request"))

    first = make()
    store = first.endpoint.store
    for i in range(5):
        store.write([P.touch(f"doc:w{i}#viewer@user:u{i % 3}")])
    first.persistence.checkpoint()
    store.write([P.delete("doc:w1#viewer@user:u1")])
    second = make()
    events = [re.sub(r" in [0-9.e-]+s$", " in <t>s", e["message"])
              for e in second.audit.recent() if e.get("stage") == "recovery"]
    return (second.endpoint.store.revision, events,
            rels_of(second.endpoint.store), second.persistence.recovered)


@pytest.mark.parametrize("url", ["embedded://", "torch://?device=cpu"])
def test_server_recovers_with_the_reference_audit_event(tmpdir, url):
    """`ProxyServer(Options(data_dir=...))` recovers before it builds its
    endpoint, skips the bootstrap relationships, and emits the recovery
    audit event in the reference's words."""
    got = _server_restart(PORT, url, os.path.join(tmpdir, "p"))
    want = _server_restart(REF, "embedded://", os.path.join(tmpdir, "r"))
    assert got == want
    assert got[1] and got[3] is True
    assert "doc:w1#viewer@user:u1" not in got[2]
