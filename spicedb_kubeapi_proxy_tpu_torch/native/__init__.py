"""The bulk relationship parser in C++ (fastparse.cpp), built at first use.

`load()` compiles the source with g++ (`-O3 -shared -fPIC -std=c++17`)
into `_build/libfastparse.so` the first time it is needed, and again
whenever the source is newer than the library, through a process-unique
temp file renamed into place (several processes may build at once).  It
is bound with ctypes over a plain C ABI, so it needs no Python headers.
A failed build or load raises with the compiler's output: nothing falls
back.  `SPICEDB_TPU_NO_NATIVE=1` is the one way to the pure-Python parser
(`ColumnarSnapshot._from_text_py`); `load()` then returns None.

`parse(text)` -> (pool, int32 [6, n] columns rtype, rid, rel, stype, sid,
srel, float64 [n] expirations with NaN for none); a bad line raises
ValueError.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).with_name("fastparse.cpp")
BUILD_DIR = Path(__file__).with_name("_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ERR_CAP = 512

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def disabled() -> bool:
    return os.environ.get("SPICEDB_TPU_NO_NATIVE", "") not in ("", "0")


def library_path() -> Path:
    return BUILD_DIR / "libfastparse.so"


def build() -> Path:
    """Compile the source into the library (unless it is up to date)."""
    out = library_path()
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed building {SOURCE} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    except OSError as e:
        raise NativeBuildError(f"g++ could not build {SOURCE}: {e}") from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def load() -> Optional[ctypes.CDLL]:
    """The parser library, built if needed; None only under
    SPICEDB_TPU_NO_NATIVE=1."""
    global _lib
    if disabled():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.fp_parse.restype = ctypes.c_void_p
            lib.fp_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p,
                                     i64p, i64p, ctypes.c_char_p,
                                     ctypes.c_int64]
            lib.fp_fill.restype = None
            lib.fp_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p]
            lib.fp_free.restype = None
            lib.fp_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def parse(text: str) -> tuple:
    """(pool, int32 [6, n] columns, float64 [n] expirations) of the
    relationship lines in `text`."""
    lib = load()
    if lib is None:
        raise NativeBuildError("the native parser is off "
                               "(SPICEDB_TPU_NO_NATIVE)")
    data = text.encode("utf-8")
    n_rows, n_pool, pool_bytes = (ctypes.c_int64(), ctypes.c_int64(),
                                  ctypes.c_int64())
    err = ctypes.create_string_buffer(ERR_CAP)
    handle = lib.fp_parse(data, len(data), ctypes.byref(n_rows),
                          ctypes.byref(n_pool), ctypes.byref(pool_bytes),
                          err, ERR_CAP)
    if not handle:
        raise ValueError(err.value.decode("utf-8", "replace"))
    try:
        n = n_rows.value
        cols = np.empty((6, n), np.int32)
        expiry = np.empty(n, np.float64)
        pool = ctypes.create_string_buffer(max(1, pool_bytes.value))
        lib.fp_fill(handle, cols.ctypes.data, expiry.ctypes.data, pool)
    finally:
        lib.fp_free(handle)
    strings = (pool.raw[: pool_bytes.value].decode("utf-8").split("\n")
               if n_pool.value else [])
    if len(strings) != n_pool.value:
        raise RuntimeError(f"native parser: pool of {n_pool.value} entries "
                           f"came back as {len(strings)}")
    return strings, cols, expiry
