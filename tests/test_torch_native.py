"""The port's native bulk parser (native/fastparse.cpp) against its
pure-Python twin and the reference's Python parser.

Every case runs through three parsers: the port's `from_text` (the C++
parser, built at first use), the port's `_from_text_py` and the
reference's `_from_text_py`; `parse_relationship` is the judge, and the
three snapshots must be equal (pool order, columns, expirations).  The
reference's native module is left out: its `load()` may rebuild the
library inside the reference package's directory.
"""

import shutil

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.spicedb.columnar import (
    ColumnarSnapshot as RefSnapshot)
from spicedb_kubeapi_proxy_tpu_torch import native
from spicedb_kubeapi_proxy_tpu_torch.spicedb.columnar import ColumnarSnapshot
from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import parse_relationship

COLS = ("rtype", "rid", "rel", "stype", "sid", "srel")

PARSERS = {
    "port_native": ColumnarSnapshot.from_text,
    "port_py": ColumnarSnapshot._from_text_py,
    "ref_py": RefSnapshot._from_text_py,
}

# the reference's corpus and bad lines (tests/test_columnar.py)
CORPUS = [
    "namespace:ns1#viewer@user:alice",
    "group:eng#member@group:sub#member",
    "doc:d1#viewer@user:*",
    "pod:ns/with:colon#namespace@namespace:ns",
    "a:b#c@d:e#...",
    "x:y#z@w:v[expiration:1234.5]",
    "tail:id#rel@u:last",
]
BAD = [
    "noseparator",
    "a:#r@u:x",
    "a:b#r@u:",
    "{{x}}:b#r@u:x",
    "x:y#z@w:v[expiration:zzz]",
    "x:y#z@w:v[expiration:0x10]",
    "x:y#z@w:v[expiration:]",
    "x:y#z@w:v[expiration:1_5]",
    "x:y#z@w:v[expiration:nan(1)]",
    "a:b#r@u:x\nbroken",
]
TEXT = "\n".join(CORPUS + ["# comment", "", "   "])


def rows(snap) -> list:
    """(key..., expiry or None) of every row."""
    out = []
    for i in range(len(snap)):
        e = float(snap.expiry[i])
        out.append(tuple(snap.key_of(i)) + (None if np.isnan(e) else e,))
    return out


def judged(lines: list) -> list:
    out = []
    for line in lines:
        r = parse_relationship(line)
        out.append((r.resource.type, r.resource.id, r.relation,
                    r.subject.type, r.subject.id, r.subject.relation,
                    r.expires_at))
    return out


def assert_same(a, b) -> None:
    assert list(a.pool) == list(b.pool)
    for c in COLS:
        got, want = getattr(a, c), getattr(b, c)
        assert got.dtype == np.int32 and got.shape == want.shape, c
        assert np.array_equal(got, want), c
    assert a.expiry.dtype == np.float64
    np.testing.assert_array_equal(a.expiry, b.expiry)


def random_corpus(seed: int, n: int = 6000) -> tuple:
    """Seeded text with expirations, `...` subjects, subject relations,
    blank, whitespace-padded and '#' lines, over 1,000+ distinct ids.
    Returns (text, the relationship lines in order)."""
    rng = np.random.default_rng(seed)
    types = ["pod", "namespace", "group", "doc", "tenant"]
    rels = ["viewer", "member", "owner", "creator"]
    lines, kept = [], []
    for _ in range(n):
        kind = rng.integers(0, 20)
        if kind == 0:
            lines.append("")
            continue
        if kind == 1:
            lines.append(f"# note {int(rng.integers(0, 99))}")
            continue
        rt = types[rng.integers(0, len(types))]
        line = (f"{rt}:{rt[0]}{int(rng.integers(0, 1500))}"
                f"#{rels[rng.integers(0, len(rels))]}"
                f"@user:u{int(rng.integers(0, 1200))}")
        tail = rng.integers(0, 6)
        if tail == 0:
            line = line.replace("@user:", "@group:") + "#member"
        elif tail == 1:
            line += "#..."
        if rng.integers(0, 5) == 0:
            line += f"[expiration:{float(rng.uniform(0, 2e9))!r}]"
        kept.append(line)
        pad = " \t" if rng.integers(0, 10) == 0 else ""
        lines.append(pad + line + pad)
    return "\n".join(lines), kept


@pytest.mark.parametrize("name", list(PARSERS))
def test_corpus_matches_parse_relationship(name):
    assert rows(PARSERS[name](TEXT)) == judged(CORPUS)


@pytest.mark.parametrize("name", list(PARSERS))
@pytest.mark.parametrize("bad", BAD)
def test_bad_lines_raise(name, bad):
    with pytest.raises(ValueError):
        PARSERS[name](bad)


@pytest.mark.parametrize("name", list(PARSERS))
def test_expiration_whitespace_tolerated(name):
    snap = PARSERS[name]("x:y#z@w:v[expiration: 7.5 ]")
    assert rows(snap) == [("x", "y", "z", "w", "v", "", 7.5)]


@pytest.mark.parametrize("name", list(PARSERS))
@pytest.mark.parametrize("text,want", [
    # U+00A0 is not ASCII whitespace: it stays part of the type field
    ("\u00a0x:y#z@w:v", ("\u00a0x", "y", "z", "w", "v", "", None)),
    # U+2028 does not split lines: it stays inside the subject id
    ("a:b#r@u:one\u2028more", ("a", "b", "r", "u", "one\u2028more", "",
                                None)),
    # multi-byte ids round-trip through the UTF-8 pool
    ("d\u00f6c:\u65e5\u672c#v@u:\U0001f600", ("d\u00f6c", "\u65e5\u672c",
                                              "v", "u", "\U0001f600", "",
                                              None)),
])
def test_ascii_strict(name, text, want):
    assert rows(PARSERS[name](text)) == [want]


@pytest.mark.parametrize("name", list(PARSERS))
@pytest.mark.parametrize("text", ["", "\n\n", "# only a comment\n  \n"])
def test_empty_texts(name, text):
    snap = PARSERS[name](text)
    assert len(snap) == 0 and list(snap.pool) == []
    assert snap.rtype.shape == (0,) and snap.expiry.shape == (0,)


@pytest.mark.parametrize("name", list(PARSERS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_corpus(name, seed):
    text, kept = random_corpus(seed)
    snap = PARSERS[name](text)
    assert len({r[1] for r in judged(kept)}) >= 1000
    assert rows(snap) == judged(kept)
    assert_same(snap, ColumnarSnapshot._from_text_py(text))


def test_native_equals_the_reference_python_parser():
    text, _ = random_corpus(7, 20000)
    assert_same(ColumnarSnapshot.from_text(text),
                RefSnapshot._from_text_py(text))


def test_from_text_runs_the_native_parser(monkeypatch):
    calls = []
    real = native.parse
    monkeypatch.setattr(native, "parse",
                        lambda text: calls.append(text) or real(text))
    monkeypatch.setattr(ColumnarSnapshot, "_from_text_py", classmethod(
        lambda cls, text: pytest.fail("the Python parser ran")))
    monkeypatch.delenv("SPICEDB_TPU_NO_NATIVE", raising=False)
    snap = ColumnarSnapshot.from_text(TEXT)
    assert calls == [TEXT] and len(snap) == len(CORPUS)
    assert native.library_path().parent == native.BUILD_DIR


def test_no_native_switch_selects_the_twin(monkeypatch):
    monkeypatch.setenv("SPICEDB_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "parse", lambda text: pytest.fail(
        "the native parser ran"))
    assert native.load() is None
    snap = ColumnarSnapshot.from_text(TEXT)
    assert rows(snap) == judged(CORPUS)


def test_failed_build_raises(monkeypatch, tmp_path):
    broken = tmp_path / "fastparse.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("SPICEDB_TPU_NO_NATIVE", raising=False)
    with pytest.raises(native.NativeBuildError, match="not C\\+\\+|error"):
        native.load()
    with pytest.raises(native.NativeBuildError):
        ColumnarSnapshot.from_text(TEXT)
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_stale_library_rebuilt(monkeypatch, tmp_path):
    src = tmp_path / "fastparse.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("SPICEDB_TPU_NO_NATIVE", raising=False)
    lib = native.library_path()
    lib.parent.mkdir()
    lib.write_bytes(b"not a library")
    import os
    os.utime(lib, (1, 1))        # older than the source: rebuilt
    snap = ColumnarSnapshot.from_text(TEXT)
    assert rows(snap) == judged(CORPUS)
    assert lib.stat().st_mtime >= src.stat().st_mtime
