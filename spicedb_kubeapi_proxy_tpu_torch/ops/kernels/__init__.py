"""Hand-written CUDA kernels of the ELL and segment fixpoint sweeps, of
the delta flush, of the Leopard plane reads and of the mesh path's
OR-combine, and their wrappers.

The tri-state (caveat) path keeps two bitplanes per state row, words
[0, H) definite and [H, 2H) maybe; the wrappers that read planes take H
as `half` (perm_program, cav_gather_or, check_gather3) or a flag
(seed_bitplanes' `planes`, lookup_T's `words`).

Each wrapper takes torch tensors.  On CUDA tensors it launches the kernel
from csrc/ell_kernels.cu (built for sm_90a with nvcc at first use, bound
with ctypes) on the current stream of the tensors' card (all on one),
and adds one to its entry in `LAUNCHES` (under a `LaunchGraph` capture,
to the graph's count, which every replay adds); a build or launch
failure raises.  On CPU tensors it runs the
plain-torch twin from reference.py instead — that is the only reason a
twin runs, and it never counts as a launch.  Any other device raises.

Build: `build()` compiles the one source file into
`_build/libell_kernels-<hash>.so` (hash of the source and the flags), via a
process-unique temp file renamed into place, so concurrent first uses and
stale libraries are both harmless.  The directory is listed in .gitignore.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import gc
import hashlib
import operator
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from . import reference

KERNEL_NAMES = ("ell_gather_or", "perm_program", "sweep_delta",
                "seed_bitplanes", "check_gather", "lookup_T", "scatter_rows",
                "cav_gather_or", "check_gather3", "edge_or", "word_cols_T",
                "or_combine", "mesh_gather_or", "mesh_cav_gather_or",
                "mesh_perm_program", "mesh_sweep_delta",
                "sweep_delta_checks")

# launches per kernel since the last reset_launches(); CPU twins never count.
# Serving threads and background rebuilds (a candidate's prewarm) launch at
# once, so every increment takes _launches_lock
LAUNCHES: dict = {name: 0 for name in KERNEL_NAMES}
_launches_lock = threading.Lock()
# a thread capturing a CUDA graph records its wrappers' launches here
# instead (LaunchGraph): they run only when the graph is replayed
_capture = threading.local()

SOURCE = Path(__file__).with_name("csrc") / "ell_kernels.cu"
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_WILDCARD_TERMS = 32   # wc_bits is one int32 bitmask per row
MAX_STACK = 16            # kMaxStack, perm_program's operand stack
MAX_PROGRAM = 4096        # perm_program instructions (shared memory)
MAX_OR_PARTS = 8          # kMaxParts, or_combine's replicas a launch
K_CAV = 8                 # kCav, the caveat table's width (cav_gather_or)
MESH_DSTS = 16            # kMeshDsts, replicas a mesh_* launch writes
MESH_JOBS = 16            # kMeshJobs, table blocks a mesh_* gather launch

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""            # nvcc's output of the last build (ptxas -v lines)


class KernelError(RuntimeError):
    pass


def reset_launches() -> None:
    with _launches_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _register_launch_metric() -> None:
    """`authz_kernel_launches{kernel=}` on /metrics: LAUNCHES as they
    stand at each scrape (since the last reset_launches()), so a
    process serving `torch://` shows which hand-written kernels it ran.
    A process that never imported this module exports none."""
    from ...utils.metrics import REGISTRY, Gauge

    class _LaunchGauge(Gauge):
        def render(self) -> list:
            with _launches_lock:
                counts = dict(LAUNCHES)
            for name, n in counts.items():
                self.set(n, kernel=name)
            return super().render()

    REGISTRY.register(_LaunchGauge(
        "authz_kernel_launches",
        "Launches of each hand-written CUDA kernel in this process since "
        "the last reset (CPU twins never count)", labels=("kernel",)))


_register_launch_metric()


def _count(name: str) -> None:
    """One launch of `name`: into LAUNCHES (under its lock: several
    threads launch at once), or into the capture this thread is
    recording (thread-local)."""
    rec = getattr(_capture, "counts", None)
    if rec is None:
        with _launches_lock:
            LAUNCHES[name] += 1
    else:
        rec[name] = rec.get(name, 0) + 1


# captures in progress on any thread, and whether the cyclic collector
# was on before the first of them began: a collection that runs on a
# capturing thread can free a dead graph (cudaGraphExecDestroy), which
# CUDA refuses there and answers by invalidating the capture, so the
# collector is paused while any capture is open
_gc_pause = {"depth": 0, "was_enabled": False}
_gc_pause_lock = threading.Lock()


@contextlib.contextmanager
def _collector_paused():
    with _gc_pause_lock:
        if _gc_pause["depth"] == 0:
            _gc_pause["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_pause["depth"] += 1
    try:
        yield
    finally:
        with _gc_pause_lock:
            _gc_pause["depth"] -= 1
            if _gc_pause["depth"] == 0 and _gc_pause["was_enabled"]:
                gc.enable()


class LaunchGraph:
    """Wrapper calls captured once in a CUDA graph and replayed.

    `capture(fn)` records what `fn` launches on `device` (kernels, copies,
    memsets; tensors it allocates come from the graph's own memory pool
    and live as long as the graph) and returns `fn`'s result; nothing runs
    until `replay()`, which launches the whole graph on the current stream
    and adds the captured launches to LAUNCHES, as the calls would have
    (under the counters' lock, like every wrapper's count).
    The capture is `torch.cuda.graph`'s in "thread_local" mode (other
    threads keep launching meanwhile) on a side stream, without that
    context's device synchronise and cache flush, with Python's cyclic
    collector paused until it ends (`_collector_paused`); `pool`
    (`torch.cuda.graph_pool_handle()`) lets graphs that never replay
    at the same time share their memory.  A capture that fails
    raises; nothing falls back to eager launches.  Every pointer the calls
    read is baked into the graph, so the caller keeps their tensors alive
    and unmoved while it may replay.

    The graph begins and ends with a timing event of its own (event record
    nodes): each replay stamps them on the card as its first node starts
    and its last one ends, and `seconds()` reads the last replay's span
    once that replay is known complete (`note_replay`)."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.counts: dict = {}
        self.marks: Optional[tuple] = None

    def capture(self, fn):
        side = torch.cuda.Stream(self.device)
        marks = tuple(torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(2))
        for ev in marks:
            # made now, outside the capture (an event is made at its
            # first record)
            ev.record(side)
        _capture.counts = counts = {}
        try:
            with _collector_paused(), torch.cuda.device(self.device), \
                    torch.cuda.stream(side):
                self.graph.capture_begin(pool=self.pool,
                                         capture_error_mode="thread_local")
                try:
                    marks[0].record(side)
                    out = fn()
                    marks[1].record(side)
                finally:
                    self.graph.capture_end()
        finally:
            _capture.counts = None
        self.counts = counts
        self.marks = marks
        return out

    def seconds(self) -> float:
        """The device span of the last replay, first node to last; the
        caller knows that replay complete (no wait here)."""
        return self.marks[0].elapsed_time(self.marks[1]) / 1e3

    def replay(self) -> None:
        """Launch the graph; its captured launches go into LAUNCHES under
        the counters' lock (a replay may run beside another thread's
        launches)."""
        self.graph.replay()
        with _launches_lock:
            for name, n in self.counts.items():
                LAUNCHES[name] += n


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                      "CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libell_kernels-{h}.so"


def build() -> Path:
    """Compile the kernels if this source has no library yet; returns the
    library path.  Raises KernelError when nvcc fails.  A build is the
    port's kernel compile: kernel accounting counts it (bucket 0) and
    the dispatch timeline shows it as a `compile` slice."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    from ...utils import devtel, timeline
    t0 = timeline.now()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    devtel.KERNELS.note_compile(0)
    timeline.record("compile", "device", t0, bucket=0)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            sigs = {
                "ell_gather_or": (P, P, L, L, P, I, I, L, I, I, P, P, P, P,
                                  P, P),
                "ell_perm_program": (P, P, I, L, I, I, I, I, P, P, P),
                "ell_cav_gather_or": (P, P, L, I, I, I, P, P),
                "ell_sweep_delta": (P, P, L, I, L, P, P),
                "ell_seed_bitplanes": (P, I, L, I, I, L, P, I, P, P, P),
                "ell_check_gather": (P, I, P, P, L, P, P),
                "ell_check_gather3": (P, I, P, P, L, P, P),
                "ell_lookup_T": (P, I, L, L, L, P, P),
                "ell_scatter_rows": (P, L, I, P, L, P, P, I, P),
                "ell_edge_or": (P, P, P, L, I, I, P, P),
                "ell_word_cols_T": (P, I, P, I, L, P, P),
                "ell_or_combine": (P, I, L, I, P),
                "ell_mesh_gather_or": (P, P, I, I, I, I, L, I, I, P),
                "ell_mesh_cav_gather_or": (P, P, I, L, I, I, I, P),
                "ell_mesh_perm_program": (P, P, I, L, I, I, I, I, P, P, I,
                                          P),
                "ell_mesh_sweep_delta": (P, P, L, I, L, P, I, P, P),
                "ell_sweep_delta_checks": (P, P, L, I, I, L, P, I, I, P,
                                           P, P),
            }
            for fn, args in sigs.items():
                f = getattr(lib, fn)
                f.argtypes = list(args)
                f.restype = ctypes.c_int
            lib.ell_error_string.argtypes = [ctypes.c_int]
            lib.ell_error_string.restype = ctypes.c_char_p
            lib.ell_stamps_open.argtypes = [ctypes.c_int]
            lib.ell_stamps_open.restype = ctypes.c_void_p
            lib.ell_stamps_close.argtypes = []
            lib.ell_stamps_close.restype = None
            lib.ell_stamps_resume.argtypes = [ctypes.c_void_p]
            lib.ell_stamps_resume.restype = None
            lib.ell_stamps_read.argtypes = [ctypes.c_void_p]
            lib.ell_stamps_read.restype = ctypes.c_double
            lib.ell_stamps_free.argtypes = [ctypes.c_void_p]
            lib.ell_stamps_free.restype = None
            _lib = lib
    return _lib


# the device window this thread's batch is recording, if any (DeviceWindow)
_window = threading.local()


class DeviceWindow:
    """The device time of one kernel batch's fixpoint (its seed and its
    sweeps), from CUDA events on the card that runs it, never from the
    host's clock around an asynchronous launch.  Each graph replay's span
    (`LaunchGraph.seconds`: the seed graph, each sweep graph) is added
    after its sweep's readback (`note_replay`); while the window is open
    on a thread, every launcher that thread calls on the window's card
    outside a graph (a seed or sweep launched step by step, the segment
    and mesh paths) records a timing event pair around its own launches
    inside its C call (`ell_stamps_open`).  Host gaps between launches
    and sweeps (the per-sweep readback, a wait for the interpreter lock)
    lie outside every pair and are not counted; a launcher's pair does
    hold its own submission when the card was idle.  The batch's result
    gather after the fixpoint is left out (`unstamped`).  `seconds()`
    sums the pairs once the batch's readback completed, so nothing
    synchronizes for it, and returns the events to the library's pool.
    On the CPU the twins are synchronous and the window is the host time
    from `open` to `close`.  `t0` is the host instant it opened (the
    timeline places the device slice there).  A mesh batch counts the
    launches on the window's own card."""

    __slots__ = ("device", "t0", "graph_s", "_set", "_s")

    def __init__(self, device):
        device = torch.device(device)
        self.device = device
        self.graph_s = 0.0
        self._set = None
        self._s: Optional[float] = None
        if device.type == "cuda":
            idx = (device.index if device.index is not None
                   else torch.cuda.current_device())
            self._set = _load().ell_stamps_open(idx)
            if not self._set:
                raise KernelError(f"no device-time stamps for card {idx}")
        _window.current = self
        self.t0 = time.perf_counter()

    def close(self) -> None:
        """Stop recording this thread's launches into the window."""
        _window.current = None
        if self.device.type == "cpu":
            self._s = time.perf_counter() - self.t0
        else:
            _load().ell_stamps_close()

    def seconds(self) -> float:
        """The summed device seconds, read once the batch's readback
        completed (each later call returns the same)."""
        if self._set is not None:
            ms = _load().ell_stamps_read(self._set)
            self._set = None
            self._s = ms / 1e3 + self.graph_s
        return self._s

    def discard(self) -> None:
        """Drop a window whose batch failed (its events back to the
        pool)."""
        if getattr(_window, "current", None) is self:
            self.close()
        if self._set is not None:
            _load().ell_stamps_free(self._set)
            self._set = None


class unstamped:
    """A block whose launches stay out of this thread's open device
    window (a batch's result gather after its fixpoint)."""

    __slots__ = ("_set",)

    def __enter__(self):
        win = getattr(_window, "current", None)
        self._set = win._set if win is not None else None
        if self._set is not None:
            _load().ell_stamps_close()
        return self

    def __exit__(self, *exc):
        if self._set is not None:
            _load().ell_stamps_resume(self._set)
        return False


def note_replay(graph: LaunchGraph) -> None:
    """Add the span of `graph`'s last replay to this thread's open device
    window, once the replay is known complete (its sweep's readback)."""
    win = getattr(_window, "current", None)
    if win is not None and win._set is not None and graph.marks is not None:
        win.graph_s += graph.seconds()


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything
    else or on a mix."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors if t is not None}) > 1:
            raise KernelError("tensors on more than one CUDA device")
        return True
    raise KernelError(f"unsupported tensor devices {sorted(kinds)}")


def _check(t: torch.Tensor, name: str, ndim: Optional[int] = None) -> None:
    if t.dtype != torch.int32:
        raise KernelError(f"{name}: expected int32, got {t.dtype}")
    if not t.is_contiguous():
        raise KernelError(f"{name}: expected a contiguous tensor")
    if ndim is not None and t.dim() != ndim:
        raise KernelError(f"{name}: expected {ndim} dims, got {t.dim()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _run(fn: str, device: torch.device, *args) -> None:
    """Launch `fn` on `device`'s current stream with `device` current, so
    a shard on another card launches in that card's context and is
    ordered after the work torch queued there.  The stream is read as a
    raw handle, and the device is switched only when another one is
    current: per call that is two lookups, not a Stream object and a
    device context."""
    lib = _load()
    idx = device.index
    if torch._C._cuda_getDevice() == idx:
        code = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            code = getattr(lib, fn)(
                *args, torch._C._cuda_getCurrentRawStream(idx))
    if code != 0:
        raise KernelError(f"{fn}: CUDA error {code}: "
                          f"{lib.ell_error_string(code).decode()}")


# -- wrappers ---------------------------------------------------------------

def ell_gather_or(cur: torch.Tensor, idx: torch.Tensor, dst_lo: int,
                  x0: Optional[torch.Tensor] = None,
                  wc_bits: Optional[torch.Tensor] = None,
                  wc_live: Optional[torch.Tensor] = None,
                  in_place: bool = False,
                  x_in: Optional[torch.Tensor] = None) -> None:
    """cur[dst_lo + r] = OR_k cur[idx[r, k]] (| seed | wildcard terms),
    every gather reading the state as it stood before the write.  `idx`
    is int32 [n, K] (a row slice of a gather table).  Three ways to get
    there: through a scratch buffer copied back into `cur` (the default);
    `in_place`, straight into `cur`, legal only when `idx` reads no row of
    the output range [dst_lo, dst_lo + n) (the caller proves it from the
    host table; the twin raises otherwise); `x_in`, straight into `cur`
    with the reads of the output range taken from `x_in`, another buffer
    that equals `cur` on those rows (the Jacobi step's sweep input)."""
    if not _on_cuda(cur, idx, x0, wc_bits, wc_live, x_in):
        return reference.ell_gather_or(cur, idx, dst_lo, x0, wc_bits, wc_live,
                                       in_place, x_in)
    _check(cur, "cur", 2)
    _check(idx, "idx", 2)
    n, k = idx.shape
    w = cur.shape[1]
    if n == 0:
        return None
    if dst_lo < 0 or dst_lo + n > cur.shape[0]:
        raise KernelError("ell_gather_or: destination rows out of range")
    seed = None
    if x0 is not None:
        _check(x0, "x0", 2)
        seed = x0[dst_lo: dst_lo + n]
    if wc_bits is not None:
        _check(wc_bits, "wc_bits", 1)
        _check(wc_live, "wc_live", 2)
        if wc_bits.shape[0] != n or wc_live.shape[1] != w:
            raise KernelError("ell_gather_or: wildcard shape mismatch")
    if x_in is not None:
        _check(x_in, "x_in", 2)
        if x_in.shape != cur.shape or x_in.data_ptr() == cur.data_ptr():
            raise KernelError("ell_gather_or: x_in must be another buffer "
                              "of the state's shape")
    dst = cur[dst_lo: dst_lo + n]
    direct = in_place or x_in is not None
    out = dst if direct else torch.empty((n, w), dtype=torch.int32,
                                         device=cur.device)
    src = cur if x_in is None else x_in
    vec = int(w % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (cur, src, out, seed, wc_live)
        if t is not None))
    iv = (4 if k % 4 == 0 and idx.data_ptr() % 16 == 0 else
          2 if k % 2 == 0 and idx.data_ptr() % 8 == 0 else 1)
    _run("ell_gather_or", cur.device, _ptr(cur), _ptr(src), dst_lo,
         0 if x_in is None else n, _ptr(idx), k, iv, n, w, vec, _ptr(seed),
         _ptr(wc_bits), _ptr(wc_live), _ptr(out),
         None if direct else _ptr(dst))
    _count("ell_gather_or")
    return None


def perm_program(cur: torch.Tensor, x0: torch.Tensor, code: torch.Tensor,
                 offset: int, length: int, in_place: bool = False,
                 half: Optional[int] = None,
                 depth: Optional[int] = None) -> None:
    """cur[offset: offset + length] = program(cur) | x0[same rows].
    `in_place` writes the rows directly; it is legal when every READ of
    the program is of the output slot itself or of a row range disjoint
    from it (the caller proves it, see ops/ell.py; the twin raises
    otherwise); else the result goes through a scratch buffer first.
    With `half` the rows are definite/maybe planes of `half` words each
    and the program runs in Kleene mode (exclusion mixes the planes).
    `depth` is the program's stack depth (default MAX_STACK): the kernel
    keeps a smaller register stack for programs at most 4 deep."""
    if not _on_cuda(cur, x0, code):
        return reference.perm_program(cur, x0, code, offset, length,
                                      in_place, half, depth)
    _check(cur, "cur", 2)
    _check(x0, "x0", 2)
    _check(code, "code", 1)
    if length == 0:
        return None
    w = cur.shape[1]
    if half is not None and 2 * half != w:
        raise KernelError(f"perm_program: half {half} != width {w} / 2")
    n_ins = code.shape[0] // 2
    if n_ins > MAX_PROGRAM:
        raise KernelError(f"perm_program: {n_ins} instructions (> "
                          f"{MAX_PROGRAM})")
    depth = MAX_STACK if depth is None else depth
    if not 0 < depth <= MAX_STACK:
        raise KernelError(f"perm_program: stack depth {depth}")
    seed = x0[offset: offset + length]
    dst = cur[offset: offset + length]
    out = dst if in_place else torch.empty((length, w), dtype=torch.int32,
                                           device=cur.device)
    vec = int((half or w) % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (cur, seed, out)))
    _run("ell_perm_program", cur.device, _ptr(cur), _ptr(code), n_ins, length,
         w, half or 0, depth, vec, _ptr(seed), _ptr(out))
    _count("perm_program")
    if not in_place:
        dst.copy_(out)
    return None


def cav_gather_or(cur: torch.Tensor, x_in: torch.Tensor, idx: torch.Tensor,
                  half: int, dst_lo: int = 0,
                  dead: Optional[int] = None) -> None:
    """Maybe plane of rows [dst_lo, dst_lo + R): cur[dst_lo + r, half:] |=
    OR_k x_in[idx[r, k], half:], with `idx` int32 [R, K_CAV] (the caveat
    table, or one row block of it; 16-byte aligned on a card) and `x_in`
    the sweep's input state (a buffer other than `cur`).  `dead` is the
    state's dead row: the kernel skips its gathers, exact because its
    words are zero (sweep_delta and the seed zero it); None skips
    nothing.  The twin gathers every index, so a comparison with it also
    checks that the dead row is zero."""
    if idx.dim() != 2 or idx.shape[1] != K_CAV:
        raise KernelError(f"cav_gather_or: table shape {tuple(idx.shape)}, "
                          f"not [R, {K_CAV}]")
    if not _on_cuda(cur, x_in, idx):
        return reference.cav_gather_or(cur, x_in, idx, half, dst_lo, dead)
    _check(cur, "cur", 2)
    _check(x_in, "x_in", 2)
    _check(idx, "idx", 2)
    r = idx.shape[0]
    if idx.data_ptr() % 16:
        raise KernelError("cav_gather_or: table rows not 16-byte aligned")
    if cur.shape != x_in.shape or cur.shape[1] != 2 * half:
        raise KernelError("cav_gather_or: state shapes do not match half")
    if dst_lo < 0 or dst_lo + r > cur.shape[0]:
        raise KernelError("cav_gather_or: table rows out of the state rows")
    if cur.data_ptr() == x_in.data_ptr():
        raise KernelError("cav_gather_or: x_in must not be the output")
    out = cur[dst_lo:]
    vec = int(half % 4 == 0 and x_in.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    _run("ell_cav_gather_or", x_in.device, _ptr(x_in), _ptr(idx), r, half,
         -1 if dead is None else dead, vec, _ptr(out))
    _count("cav_gather_or")
    return None


def sweep_delta(x_new: torch.Tensor, x_old: torch.Tensor,
                dead: int) -> torch.Tensor:
    """Zero x_new's dead row, then int32 [2] on x_new's device:
    [popcount(x_new ^ x_old) mod 2^32, any(x_new != x_old)]."""
    if not _on_cuda(x_new, x_old):
        return reference.sweep_delta(x_new, x_old, dead)
    _check(x_new, "x_new", 2)
    _check(x_old, "x_old", 2)
    if x_new.shape != x_old.shape:
        raise KernelError("sweep_delta: shape mismatch")
    out = torch.empty(2, dtype=torch.int32, device=x_new.device)
    nt, w = x_new.shape
    _run("ell_sweep_delta", x_new.device, _ptr(x_new), _ptr(x_old), nt, w, dead, _ptr(out))
    _count("sweep_delta")
    return out


def sweep_delta_checks(x_new: torch.Tensor, x_old: torch.Tensor, dead: int,
                       tail: torch.Tensor, out: torch.Tensor,
                       half: Optional[int] = None,
                       host: Optional[torch.Tensor] = None,
                       slot: int = 0) -> torch.Tensor:
    """The ELL sweep's tail in one launch: `sweep_delta` and the batch's
    check gather from the new state.  Zeroes x_new's dead row, then
    writes `out`, int32 [4 + nw] ([4 + 2 nw] with `half`): pair `slot`
    (out[2 slot], out[2 slot + 1], which must hold zero or a sum to add
    to) gets [popcount(x_new ^ x_old) mod 2^32, any(x_new != x_old)] and
    the other pair is zeroed, for the next sweep to take; out[4 + w] bit b
    = the definite bit of check slot 32 w + b, and with `half` (rows of
    definite and maybe planes of `half` words) out[4 + nw + w] bit b =
    its maybe-and-not-definite bit; every answer word is written, zero
    past G.  `tail` is int32 [2 + 64 nw]: tail[0] = G (the slots in use,
    clamped to [0, 32 nw]), tail[1] unused, then the slots' (state row,
    query column) pairs from tail[2].  `host`, a pinned CPU tensor of
    out's shape (CUDA only), receives a copy of `out` on the same stream
    after the kernel.  Returns `out`."""
    if tail.dim() != 1 or (tail.shape[0] - 2) % 64:
        raise KernelError(f"sweep_delta_checks: tail of {tuple(tail.shape)}"
                          f", not [2 + 64 nw]")
    nw = (tail.shape[0] - 2) // 64
    want = 4 + nw * (1 if half is None else 2)
    if out.dim() != 1 or out.shape[0] != want:
        raise KernelError(f"sweep_delta_checks: out of {tuple(out.shape)}, "
                          f"not [{want}]")
    if slot not in (0, 1):
        raise KernelError(f"sweep_delta_checks: slot {slot}, not 0 or 1")
    if not _on_cuda(x_new, x_old, tail, out):
        if host is not None:
            raise KernelError("sweep_delta_checks: a host copy is a CUDA "
                              "launch's")
        return reference.sweep_delta_checks(x_new, x_old, dead, tail, out,
                                            half, slot)
    _check(x_new, "x_new", 2)
    _check(x_old, "x_old", 2)
    _check(tail, "tail", 1)
    _check(out, "out", 1)
    if x_new.shape != x_old.shape:
        raise KernelError("sweep_delta_checks: shape mismatch")
    nt, s = x_new.shape
    if half is not None and 2 * half != s:
        raise KernelError(f"sweep_delta_checks: half {half} != width {s} / 2")
    if not 0 <= dead < nt:
        raise KernelError("sweep_delta_checks: dead row out of range")
    if tail.data_ptr() % 8:
        raise KernelError("sweep_delta_checks: tail not 8-byte aligned")
    if host is not None and (host.device.type != "cpu" or not host.is_pinned()
                             or host.dtype != torch.int32
                             or host.shape != out.shape):
        raise KernelError("sweep_delta_checks: host must be a pinned int32 "
                          "CPU tensor of out's shape")
    _run("ell_sweep_delta_checks", x_new.device, _ptr(x_new), _ptr(x_old), nt,
         s, half or 0, dead, _ptr(tail), nw, slot, _ptr(out), _ptr(host))
    _count("sweep_delta_checks")
    return out


def seed_bitplanes(q_idx: torch.Tensor, nt: int, n_words: int, dead: int,
                   out: Optional[torch.Tensor] = None,
                   wc_ranges: Optional[torch.Tensor] = None,
                   live: Optional[torch.Tensor] = None,
                   planes: bool = False) -> torch.Tensor:
    """One-hot packed state [nt, n_words] from per-column state rows.
    With `wc_ranges` (int32 [T, 2] self-row ranges of the wildcard terms)
    it also fills `live` (int32 [T, n_words]): the columns whose seed row
    lies in each range — the wildcard liveness of every sweep.  With
    `planes` both are [.., 2 * n_words], the bits set in both planes."""
    if not _on_cuda(q_idx, out, wc_ranges, live):
        return reference.seed_bitplanes(q_idx, nt, n_words, dead, out,
                                        wc_ranges, live, planes)
    _check(q_idx, "q_idx", 1)
    if q_idx.shape[0] > 32 * n_words:
        raise KernelError("seed_bitplanes: more columns than lanes")
    width = 2 * n_words if planes else n_words
    if out is None:
        out = torch.empty((nt, width), dtype=torch.int32,
                          device=q_idx.device)
    _check(out, "out", 2)
    if tuple(out.shape) != (nt, width):
        raise KernelError("seed_bitplanes: out shape mismatch")
    n_wc = 0
    if wc_ranges is not None:
        _check(wc_ranges, "wc_ranges", 2)
        _check(live, "live", 2)
        n_wc = wc_ranges.shape[0]
        if live.shape[0] < n_wc or live.shape[1] != width:
            raise KernelError("seed_bitplanes: live shape mismatch")
    _run("ell_seed_bitplanes", q_idx.device, _ptr(q_idx), q_idx.shape[0], nt, n_words,
         int(planes), dead, _ptr(wc_ranges), n_wc, _ptr(out), _ptr(live))
    _count("seed_bitplanes")
    return out


def check_gather(x: torch.Tensor, gather_idx: torch.Tensor,
                 gather_col: torch.Tensor) -> torch.Tensor:
    """int32 [G] tri-state-encoded ({0, 2}) check bits."""
    if not _on_cuda(x, gather_idx, gather_col):
        return reference.check_gather(x, gather_idx, gather_col)
    _check(x, "x", 2)
    _check(gather_idx, "gather_idx", 1)
    _check(gather_col, "gather_col", 1)
    g = gather_idx.shape[0]
    out = torch.empty(g, dtype=torch.int32, device=x.device)
    _run("ell_check_gather", x.device, _ptr(x), x.shape[1], _ptr(gather_idx),
         _ptr(gather_col), g, _ptr(out))
    _count("check_gather")
    return out


def check_gather3(x: torch.Tensor, gather_idx: torch.Tensor,
                  gather_col: torch.Tensor, half: int) -> torch.Tensor:
    """int32 [G] tri-state checks of a definite/maybe state ([NT, 2 *
    half]): 2 = HAS, 1 = CONDITIONAL (maybe, not definite), 0 = NO."""
    if not _on_cuda(x, gather_idx, gather_col):
        return reference.check_gather3(x, gather_idx, gather_col, half)
    _check(x, "x", 2)
    _check(gather_idx, "gather_idx", 1)
    _check(gather_col, "gather_col", 1)
    if x.shape[1] != 2 * half:
        raise KernelError(f"check_gather3: half {half} != width "
                          f"{x.shape[1]} / 2")
    g = gather_idx.shape[0]
    out = torch.empty(g, dtype=torch.int32, device=x.device)
    _run("ell_check_gather3", x.device, _ptr(x), half, _ptr(gather_idx),
         _ptr(gather_col), g, _ptr(out))
    _count("check_gather3")
    return out


def lookup_T(x: torch.Tensor, offset: int, length: int,
             words: Optional[int] = None) -> torch.Tensor:
    """int32 [words, length]: the first `words` words (default all; the
    definite plane of a tri-state state) of state rows [offset, offset +
    length), transposed."""
    if not _on_cuda(x):
        return reference.lookup_T(x, offset, length, words)
    _check(x, "x", 2)
    if offset < 0 or offset + length > x.shape[0]:
        raise KernelError("lookup_T: rows out of range")
    w = x.shape[1] if words is None else words
    if not 0 < w <= x.shape[1]:
        raise KernelError(f"lookup_T: {w} words of a {x.shape[1]}-word row")
    out = torch.empty((w, length), dtype=torch.int32, device=x.device)
    _run("ell_lookup_T", x.device, _ptr(x), w, x.shape[1], offset, length, _ptr(out))
    _count("lookup_T")
    return out


def scatter_rows(src: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Copy-on-write row scatter: a new int32 [R, K] tensor equal to `src`
    with row rows[i] replaced by vals[i] (`rows` int32 [b], `vals` int32
    [b, K]).  `src` is never written.  Duplicate rows must carry equal
    values; rows outside [0, R) are skipped."""
    if not _on_cuda(src, rows, vals):
        return reference.scatter_rows(src, rows, vals)
    _check(src, "src", 2)
    _check(rows, "rows", 1)
    _check(vals, "vals", 2)
    r, k = src.shape
    b = rows.shape[0]
    if tuple(vals.shape) != (b, k):
        raise KernelError(f"scatter_rows: vals shape {tuple(vals.shape)} != "
                          f"({b}, {k})")
    out = torch.empty_like(src)
    vec = int(src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _run("ell_scatter_rows", src.device, _ptr(src), r, k, _ptr(rows), b, _ptr(vals),
         _ptr(out), vec)
    _count("scatter_rows")
    return out


def edge_or(y: torch.Tensor, x: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor, dead: Optional[int] = None) -> None:
    """The segment sweep's edge pass: y[dst[e], w] |= x[src[e], w] for
    every edge e and word w.  `x` and `y` are int32 [N, W] packed states,
    distinct buffers (Jacobi: every edge reads the sweep's input);
    `src`/`dst` int32 [E] row indices in [0, N).  `dead` is the state's
    dead row: the kernel skips the edges whose source it is (padding and
    freed positions), exact because its words are zero (sweep_delta and
    the seed zero it); None skips nothing.  The twin gathers every edge,
    so a comparison with it also checks that the dead row is zero.  The
    shapes and `dead` are checked on every device."""
    if x.dim() != 2 or y.shape != x.shape:
        raise KernelError(f"edge_or: states {tuple(x.shape)} and "
                          f"{tuple(y.shape)}, not two equal [N, W]")
    if src.dim() != 1 or src.shape != dst.shape:
        raise KernelError("edge_or: src and dst are not two equal [E]")
    if y.data_ptr() == x.data_ptr():
        raise KernelError("edge_or: y must not be the input state")
    if dead is not None:
        try:
            dead = operator.index(dead)
        except TypeError:
            raise KernelError(f"edge_or: dead row {dead!r} is not an "
                              f"integer") from None
        if not 0 <= dead < x.shape[0]:
            raise KernelError(f"edge_or: dead row {dead} outside [0, "
                              f"{x.shape[0]})")
    if not _on_cuda(y, x, src, dst):
        return reference.edge_or(y, x, src, dst, dead)
    _check(y, "y", 2)
    _check(x, "x", 2)
    _check(src, "src", 1)
    _check(dst, "dst", 1)
    _run("ell_edge_or", x.device, _ptr(x), _ptr(src), _ptr(dst), src.shape[0],
         x.shape[1], -1 if dead is None else dead, _ptr(y))
    _count("edge_or")
    return None


def word_cols_T(plane: torch.Tensor, rows: int,
                words: torch.Tensor) -> torch.Tensor:
    """int32 [K, rows]: out[k, r] = plane[r, words[k]] — word columns of
    a closure plane (int32 [R, Wc]) made contiguous, in a new tensor.
    Words may repeat; each must lie in [0, Wc)."""
    if plane.dim() != 2 or words.dim() != 1:
        raise KernelError("word_cols_T: plane not [R, Wc] or words not [K]")
    if not 0 <= rows <= plane.shape[0]:
        raise KernelError(f"word_cols_T: {rows} rows of a "
                          f"{plane.shape[0]}-row plane")
    if not _on_cuda(plane, words):
        return reference.word_cols_T(plane, rows, words)
    _check(plane, "plane", 2)
    _check(words, "words", 1)
    k = words.shape[0]
    out = torch.empty((k, rows), dtype=torch.int32, device=plane.device)
    _run("ell_word_cols_T", plane.device, _ptr(plane), plane.shape[1], _ptr(words), k,
         rows, _ptr(out))
    _count("word_cols_T")
    return out


def or_combine(parts: list) -> None:
    """The OR all-reduce of one data shard's co-located graph replicas:
    every parts[g] becomes parts[0] | ... | parts[G-1], in place, in one
    launch for G >= 2 (G = 1 leaves the replica as it is and launches
    nothing).  The parts are int32 packed words of one shape on one
    device, at most MAX_OR_PARTS of them, no two sharing memory — the
    compute half of the sharded segment kernel's OR all-reduce over
    `graph` (a peer on another card is copied next to the others
    first, parallel/collectives.py)."""
    if not parts:
        raise KernelError("or_combine: no replicas")
    if not _on_cuda(*parts):
        return reference.or_combine(parts)
    g = len(parts)
    if g > MAX_OR_PARTS:
        raise KernelError(f"or_combine: {g} replicas (> {MAX_OR_PARTS})")
    for i, t in enumerate(parts):
        _check(t, f"parts[{i}]")
        if t.shape != parts[0].shape:
            raise KernelError(f"or_combine: shapes {tuple(parts[0].shape)} "
                              f"and {tuple(t.shape)} differ")
    n = parts[0].numel()
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * n) for t in parts)
    if n and any(b[0] < a[1] for a, b in zip(spans, spans[1:])):
        raise KernelError("or_combine: two replicas share memory")
    if g == 1 or n == 0:
        return None
    ptrs = (ctypes.c_void_p * g)(*(t.data_ptr() for t in parts))
    vec = int(all(t.data_ptr() % 16 == 0 for t in parts))
    _run("ell_or_combine", parts[0].device, ptrs, g, n, vec)
    _count("or_combine")
    return None


# -- the sharded ELL sweep (parallel/sharding.py ShardedEllKernel.step) -----
#
# One launch covers a card's share of a sweep step: every shard block on
# the card (mesh_gather_or, mesh_cav_gather_or), or one data shard
# (mesh_perm_program, mesh_sweep_delta); each result is written into every
# co-located replica of its data shard (`dsts`, at most MESH_DSTS).  The
# argument checks run on every device, so the CPU tests check each plan.

def _span(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())


def _check_disjoint(name: str, dsts: list, srcs: list) -> None:
    """Raise unless the destinations (contiguous tensors) share no memory
    with each other or with any source."""
    d = sorted(_span(t) for t in dsts if t.numel())
    if any(b[0] < a[1] for a, b in zip(d, d[1:])):
        raise KernelError(f"{name}: two destinations share memory")
    starts = [a for a, _ in d]
    for s0, s1 in {_span(t) for t in srcs if t is not None and t.numel()}:
        i = bisect.bisect_right(starts, s0) - 1
        if (i >= 0 and d[i][1] > s0) or (i + 1 < len(d)
                                         and d[i + 1][0] < s1):
            raise KernelError(f"{name}: a destination overlaps a source")


def _check_dsts(name: str, dsts: list, shape: tuple) -> None:
    if not 1 <= len(dsts) <= MESH_DSTS:
        raise KernelError(f"{name}: {len(dsts)} destinations (1 to "
                          f"{MESH_DSTS})")
    for t in dsts:
        if tuple(t.shape) != shape:
            raise KernelError(f"{name}: a destination of shape "
                              f"{tuple(t.shape)}, not {shape}")


def _ptr_array(rows: list) -> tuple:
    """ctypes (pointers, counts) for the launchers: each row is a job's
    fixed pointers then its destinations, padded to MESH_DSTS."""
    per = len(rows[0][0]) + MESH_DSTS
    ptrs = (ctypes.c_void_p * (per * len(rows)))()
    counts = (ctypes.c_int * len(rows))()
    for j, (fixed, dsts) in enumerate(rows):
        base = j * per
        ptrs[base: base + len(fixed)] = [_ptr(t) for t in fixed]
        ptrs[base + len(fixed): base + len(fixed) + len(dsts)] = [
            t.data_ptr() for t in dsts]
        counts[j] = len(dsts)
    return ptrs, counts


def mesh_gather_or(jobs: list, split: int) -> None:
    """One pass of the sharded ELL sweep's gathers for every shard block
    of `jobs`, each job (idx, lo, hi, seed, wc_bits, wc_live, dsts):
    y[r] = OR_k src(idx[r, k]) | seed[r] | OR over the set bits t of
    wc_bits[r] of wc_live[t], where src(s) is lo[s] for s < split and
    hi[s - split] past it, written into every tensor of dsts.  `idx` is
    int32 [n, K] (a table block; n and K equal over the jobs), lo and hi
    [.., W] state rows, seed [n, W], wc_bits [n] and wc_live [T, W] or
    None, dsts [n, W] row blocks (1 to MESH_DSTS).  No destination may
    share memory with another or with a source (checked here on every
    device), so every read sees the rows as they stood before the call.
    One launch for each MESH_JOBS jobs."""
    if not jobs:
        return None
    n, k = jobs[0][0].shape
    w = jobs[0][1].shape[1]
    dsts_all, srcs = [], []
    for idx, lo, hi, seed, wc_bits, wc_live, dsts in jobs:
        if idx.dim() != 2 or tuple(idx.shape) != (n, k):
            raise KernelError(f"mesh_gather_or: a table block of shape "
                              f"{tuple(idx.shape)}, not ({n}, {k})")
        if lo.dim() != 2 or hi.dim() != 2 or lo.shape[1] != w or \
                hi.shape[1] != w or lo.shape[0] < split:
            raise KernelError("mesh_gather_or: sources are not [.., W] "
                              "rows covering the split")
        if seed is not None and tuple(seed.shape) != (n, w):
            raise KernelError("mesh_gather_or: seed shape mismatch")
        if (wc_bits is None) != (wc_live is None) or (
                wc_bits is not None and (wc_bits.shape[0] != n
                                         or wc_live.shape[1] != w)):
            raise KernelError("mesh_gather_or: wildcard shape mismatch")
        _check_dsts("mesh_gather_or", dsts, (n, w))
        dsts_all += dsts
        srcs += [idx, lo, hi, seed, wc_bits, wc_live]
    _check_disjoint("mesh_gather_or", dsts_all, srcs)
    if not _on_cuda(*srcs, *dsts_all):
        return reference.mesh_gather_or(jobs, split)
    for t in srcs + dsts_all:
        if t is not None:
            _check(t, "mesh_gather_or")
    if n == 0:
        return None
    rows = [t for job in jobs for t in (job[1], job[2], job[3], job[5])
            if t is not None] + dsts_all
    vec = int(w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rows))
    ix = [job[0].data_ptr() for job in jobs]
    iv = (4 if k % 4 == 0 and all(p % 16 == 0 for p in ix) else
          2 if k % 2 == 0 and all(p % 8 == 0 for p in ix) else 1)
    for c in range(0, len(jobs), MESH_JOBS):
        chunk = jobs[c: c + MESH_JOBS]
        ptrs, counts = _ptr_array([(job[:6], job[6]) for job in chunk])
        _run("ell_mesh_gather_or", jobs[0][0].device, ptrs, counts,
             len(chunk), split, k, iv, n, w, vec)
        _count("mesh_gather_or")
    return None


def mesh_cav_gather_or(jobs: list, half: int,
                       dead: Optional[int] = None) -> None:
    """The caveat gathers of one sharded sweep for every shard block of
    `jobs`, each job (idx, x_in, dsts): dst[r, half:] |= OR_k x_in[idx[r,
    k], half:] for every row r of idx (int32 [R, K_CAV], R equal over the
    jobs; 16-byte aligned on a card) and every dst of dsts ([R, 2 * half]
    row blocks of the co-located replicas, 1 to MESH_DSTS).  x_in is the
    sweep's input ([rows, 2 * half]); no destination may share memory with
    another or with a source.  `dead` is the state's dead row, whose
    gathers the kernel skips (its words are zero); None skips nothing.
    One launch for each MESH_JOBS jobs."""
    if not jobs:
        return None
    r = jobs[0][0].shape[0]
    dsts_all, srcs = [], []
    for idx, x_in, dsts in jobs:
        if idx.dim() != 2 or tuple(idx.shape) != (r, K_CAV):
            raise KernelError(f"mesh_cav_gather_or: table block of shape "
                              f"{tuple(idx.shape)}, not ({r}, {K_CAV})")
        if x_in.dim() != 2 or x_in.shape[1] != 2 * half:
            raise KernelError("mesh_cav_gather_or: state width is not "
                              "2 * half")
        _check_dsts("mesh_cav_gather_or", dsts, (r, 2 * half))
        dsts_all += dsts
        srcs += [idx, x_in]
    _check_disjoint("mesh_cav_gather_or", dsts_all, srcs)
    if not _on_cuda(*srcs, *dsts_all):
        return reference.mesh_cav_gather_or(jobs, half, dead)
    for t in srcs + dsts_all:
        _check(t, "mesh_cav_gather_or")
    if any(job[0].data_ptr() % 16 for job in jobs):
        raise KernelError("mesh_cav_gather_or: table rows not 16-byte "
                          "aligned")
    if r == 0 or half <= 0:
        return None
    vec = int(half % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in
                                    [job[1] for job in jobs] + dsts_all))
    for c in range(0, len(jobs), MESH_JOBS):
        chunk = jobs[c: c + MESH_JOBS]
        ptrs, counts = _ptr_array([(job[:2], job[2]) for job in chunk])
        _run("ell_mesh_cav_gather_or", jobs[0][0].device, ptrs, counts,
             len(chunk), r, half, -1 if dead is None else dead, vec)
        _count("mesh_cav_gather_or")
    return None


def mesh_perm_program(cur: torch.Tensor, x0: torch.Tensor,
                      code: torch.Tensor, offset: int, length: int,
                      dsts: list, half: Optional[int] = None,
                      depth: Optional[int] = None) -> None:
    """perm_program of `cur` (one replica of a data shard), its rows
    written into rows [offset, offset + length) of every tensor of dsts
    (the shard's co-located replicas, `cur` among them; 1 to MESH_DSTS,
    of cur's shape, sharing no memory), in place.  In place is legal when
    every READ is of the slot itself or of a range disjoint from it (the
    plan checks it; the twin raises otherwise).  `half` and `depth` as
    perm_program's."""
    _check_dsts("mesh_perm_program", dsts, tuple(cur.shape))
    _check_disjoint("mesh_perm_program", dsts, [x0, code])
    if not _on_cuda(cur, x0, code, *dsts):
        return reference.mesh_perm_program(cur, x0, code, offset, length,
                                           dsts, half, depth)
    for t, name in ((cur, "cur"), (x0, "x0"), (code, "code")):
        _check(t, name)
    if length == 0:
        return None
    w = cur.shape[1]
    if half is not None and 2 * half != w:
        raise KernelError(f"mesh_perm_program: half {half} != width {w} / 2")
    n_ins = code.shape[0] // 2
    if n_ins > MAX_PROGRAM:
        raise KernelError(f"mesh_perm_program: {n_ins} instructions (> "
                          f"{MAX_PROGRAM})")
    depth = MAX_STACK if depth is None else depth
    if not 0 < depth <= MAX_STACK:
        raise KernelError(f"mesh_perm_program: stack depth {depth}")
    seed = x0[offset: offset + length]
    outs = [t[offset: offset + length] for t in dsts]
    for t in dsts:
        _check(t, "dsts")
    vec = int((half or w) % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in [cur, seed] + outs))
    ptrs = (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))
    _run("ell_mesh_perm_program", cur.device, _ptr(cur), _ptr(code), n_ins,
         length, w, half or 0, depth, vec, _ptr(seed), ptrs, len(outs))
    _count("mesh_perm_program")
    return None


def mesh_sweep_delta(x_new: torch.Tensor, x_old: torch.Tensor, dead: int,
                     out: torch.Tensor, dsts: list) -> None:
    """sweep_delta of one data shard's co-located replicas: zero the dead
    row of every tensor of dsts (x_new among them; 1 to MESH_DSTS of its
    shape), and add [popcount(x_new ^ x_old), any(x_new != x_old)] (x_new's
    dead row read as zero) into `out`, int32 [2] that the caller zeroed:
    a slot of one device tensor for the whole sweep, read back once."""
    if x_new.shape != x_old.shape or x_new.dim() != 2:
        raise KernelError("mesh_sweep_delta: states are not two equal "
                          "[N, W]")
    if tuple(out.shape) != (2,):
        raise KernelError("mesh_sweep_delta: out is not [2]")
    if not 0 <= dead < x_new.shape[0]:
        raise KernelError(f"mesh_sweep_delta: dead row {dead} outside the "
                          f"state")
    _check_dsts("mesh_sweep_delta", dsts, tuple(x_new.shape))
    _check_disjoint("mesh_sweep_delta", dsts, [x_old, out])
    if not _on_cuda(x_new, x_old, out, *dsts):
        return reference.mesh_sweep_delta(x_new, x_old, dead, out, dsts)
    for t, name in ((x_new, "x_new"), (x_old, "x_old"), (out, "out")):
        _check(t, name)
    for t in dsts:
        _check(t, "dsts")
    nt, w = x_new.shape
    ptrs = (ctypes.c_void_p * len(dsts))(*(t.data_ptr() for t in dsts))
    _run("ell_mesh_sweep_delta", x_new.device, _ptr(x_new), _ptr(x_old), nt,
         w, dead, ptrs, len(dsts), _ptr(out))
    _count("mesh_sweep_delta")
    return None
