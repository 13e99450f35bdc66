"""Segment (COO edge list) reachability sweep on torch.

The torch counterpart of the reference's ops/spmv.py, the second kernel
kind of the endpoint (`TorchEndpoint(kernel="segment")` or
`SPICEDB_TPU_KERNEL=segment`).  The reference sweeps a float32 state
[N, B] with a gather + `segment_sum` over flat padded edge arrays:

    y  = segment_sum(x[edge_src], edge_dst) > 0
    y |= wildcard masks (live when a self row of the term is set)
    x1 = max(y, x0), then each permission op in program order, ORed with
         its seed slice; the dead row forced to zero.

The port keeps the state bit-packed, int32 [N, W] (W = lanes / 32), as
ops/ell.py does, and runs every part of that sweep as a hand-written
CUDA kernel (ops/kernels): the seed and the wildcard liveness
(`seed_bitplanes`), `x0 | wildcard terms` (`ell_gather_or` over no
gathers; a plain copy of the seed when the program has no wildcard
term), the edge pass `y[dst] |= x[src]` (`edge_or`, which skips the
dead row's edges), the permission ops
(`perm_program`) and the trace and convergence test (`sweep_delta`).
A sum of 0/1 values is positive exactly when one of them is 1, so the
packed OR is the reference's function; the popcount of `x1 ^ x` equals
the reference's count of changed entries because padding lanes (dead
seeds) stay zero.  Reads are `check_gather` and `lookup_T`.

Wildcard liveness comes from the seed: no edge targets a self slot, so
the self rows of every sweep's input equal the seed's (the ELL design
rule), which makes the reference's per-sweep OR over them exact.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import devtel
from . import kernels
from .ell import _to_device, compile_perm_program
from .graph_compile import GraphProgram

# Default iteration cap == the embedded reference's max dispatch depth.
MAX_ITERATIONS = 50


def bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two bucket >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_edges(prog: GraphProgram, capacity: Optional[int] = None) -> tuple:
    """Pad edge arrays into a power-of-two bucket; padding edges read the
    dead index (always 0) and write the dead index (never read)."""
    e = len(prog.edge_src)
    cap = capacity if capacity is not None else bucket(max(e, 1))
    if cap < e:
        raise ValueError(f"capacity {cap} < edge count {e}")
    src = np.full(cap, prog.dead_index, np.int32)
    dst = np.full(cap, prog.dead_index, np.int32)
    src[:e] = prog.edge_src
    dst[:e] = prog.edge_dst
    return src, dst


@dataclass
class _Arena:
    """One word bucket's state buffers, int32 [N, W] each: the seed and
    the two sweep states the fixpoint loop swaps between."""
    x0: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor


class KernelCache(devtel.ArenaLedger):
    """Packed check/lookup entry points of the segment sweep for one
    program on one device — the pipelined entries of the reference's
    spmv.KernelCache (`_pipe_fns`), with the sweep trace always on:
    every call returns an int32 [1 + num_iters] trace, entry 0 the
    executed sweep count and entry 1 + i the changed bits of sweep i.
    Checks are {0, 2} (the segment kernel has no MAYBE plane).  Its
    pooled arenas are ledger rows of its graph generation."""

    # metric label of authz_sweep_iterations / authz_frontier_decay
    kernel_name = "segment"

    def __init__(self, prog: GraphProgram, device,
                 num_iters: Optional[int] = None):
        self.prog = prog
        self.device = torch.device(device)
        self.num_iters = num_iters or MAX_ITERATIONS
        self._build_plan()
        self._arenas: dict = {}
        self._arena_lock = threading.Lock()

    def _build_plan(self) -> None:
        """Upload what the kernels read, once: the wildcard terms' self
        ranges and per-row term bits, and each permission op's program."""
        prog, dev = self.prog, self.device
        n = prog.state_size
        terms = list(prog.wildcard_terms)
        if len(terms) > kernels.MAX_WILDCARD_TERMS:
            raise NotImplementedError(
                f"{len(terms)} wildcard terms exceed the kernel's "
                f"{kernels.MAX_WILDCARD_TERMS}")
        self._wc_ranges = (torch.tensor(
            [[t.self_offset, t.self_offset + t.self_length] for t in terms],
            dtype=torch.int32, device=dev) if terms else None)
        bits = np.zeros(n, np.uint32)
        for i, t in enumerate(terms):
            bits[np.asarray(t.mask_indices, np.int64)] |= (
                np.uint32(1) << np.uint32(i))
        self._wc_bits = (torch.from_numpy(bits.view(np.int32)).to(dev)
                         if bits.any() else None)
        # the init step's gather table: N rows, no gathers
        self._no_gathers = torch.empty((n, 0), dtype=torch.int32, device=dev)
        ops = []
        for op in prog.perm_ops:
            code, depth, self_read = compile_perm_program(op.expr, op.offset,
                                                          op.length)
            if depth > kernels.MAX_STACK:
                raise NotImplementedError(
                    f"permission expression needs a stack of {depth} "
                    f"(> {kernels.MAX_STACK})")
            ops.append((torch.from_numpy(code).to(dev), op.offset, op.length,
                        not self_read, depth))
        self._ops = ops

    # -- state arenas --------------------------------------------------------

    def take_arena(self, n_words: int) -> _Arena:
        """Pop the bucket's state arena (exclusive: two in-flight calls
        never share one); allocated on first use."""
        with self._arena_lock:
            a = self._arenas.pop(n_words, None)
        if a is not None:
            return a
        a = _Arena(*(torch.empty((self.prog.state_size, n_words),
                                 dtype=torch.int32, device=self.device)
                     for _ in range(3)))
        self._ledger_arena(n_words, a)
        return a

    def _arena_tensors(self, arena: _Arena) -> tuple:
        return (arena.x0, arena.a, arena.b)

    def put_arena(self, n_words: int, arena: _Arena) -> None:
        with self._arena_lock:
            self._arenas.setdefault(n_words, arena)

    def discard_arena(self, n_words: int) -> None:
        with self._arena_lock:
            self._arenas.pop(n_words, None)
        self._unledger_arena(n_words)

    # -- the sweep -----------------------------------------------------------

    def init_state(self, q_idx: torch.Tensor, n_words: int,
                   out: Optional[torch.Tensor] = None) -> tuple:
        """One-hot packed seed [N, n_words] (dead row zero) and the
        wildcard liveness [T, n_words] (None without wildcard terms)."""
        prog = self.prog
        live = None
        if self._wc_ranges is not None:
            live = torch.empty((self._wc_ranges.shape[0], n_words),
                               dtype=torch.int32, device=self.device)
        x0 = kernels.seed_bitplanes(q_idx, prog.state_size, n_words,
                                    prog.dead_index, out=out,
                                    wc_ranges=self._wc_ranges, live=live)
        return x0, live

    def sweep_steps(self, edge_src: torch.Tensor, edge_dst: torch.Tensor):
        """The kernel calls of one sweep, in order: ("init", wc_bits) —
        y = x0 | wildcard terms on every row; ("edge_or", src, dst,
        dead), `dead` the dead row whose edges (padding, freed positions)
        the kernel skips; then ("perm_program", code, offset, length,
        in_place, depth) per op."""
        yield ("init", self._wc_bits)
        yield ("edge_or", edge_src, edge_dst, self.prog.dead_index)
        for op in self._ops:
            yield ("perm_program", *op)

    def run_step(self, step, y, x, x0, live, impl=kernels) -> None:
        """Run one sweep step into `y` with `impl` — the kernel wrappers,
        or their twins (kernels.reference) to hold a kernel against its
        plain version on the same inputs.  `x` is the sweep's input."""
        kind = step[0]
        if kind == "init":
            wc = step[1]
            if wc is None:
                y.copy_(x0)
            else:
                impl.ell_gather_or(y, self._no_gathers, 0, x0=x0, wc_bits=wc,
                                   wc_live=live)
        elif kind == "edge_or":
            _, src, dst, dead = step
            impl.edge_or(y, x, src, dst, dead=dead)
        else:
            _, code, off, length, in_place, depth = step
            impl.perm_program(y, x0, code, off, length, in_place=in_place,
                              depth=depth)

    def evaluate(self, q_idx: torch.Tensor, n_words: int, edge_src,
                 edge_dst, arena: _Arena) -> tuple:
        """Seed, then sweep to the fixpoint (or the iteration cap).
        Returns (final state — one of the arena's buffers, trace)."""
        dead = self.prog.dead_index
        x0, live = self.init_state(q_idx, n_words, out=arena.x0)
        x, y = arena.a, arena.b
        x.copy_(x0)
        steps = list(self.sweep_steps(edge_src, edge_dst))
        trace = np.zeros(1 + self.num_iters, np.int32)
        i = 0
        changed = True
        while changed and i < self.num_iters:
            for step in steps:
                self.run_step(step, y, x, x0, live)
            delta, any_change = kernels.sweep_delta(y, x, dead).tolist()
            trace[1 + i] = delta
            changed = bool(any_change)
            i += 1
            x, y = y, x
        trace[0] = i
        return x, trace

    def _run(self, n_words: int, q_idx, edge_src, edge_dst, finish) -> tuple:
        arena = self.take_arena(n_words)
        try:
            q = _to_device(q_idx, self.device)
            x, trace = self.evaluate(q, n_words, edge_src, edge_dst, arena)
            with kernels.unstamped():
                out = finish(x)
        except BaseException:
            # after a failed call the bucket's buffers are suspect
            self.discard_arena(n_words)
            raise
        self.put_arena(n_words, arena)
        return out, trace

    # -- pipelined entry points ----------------------------------------------

    def checks_device(self, q_idx, n_words: int, gather_idx, gather_col,
                      edge_src, edge_dst) -> tuple:
        """{0, 2} checks per gather slot: (int32 [G] device tensor,
        trace)."""
        gi = _to_device(gather_idx, self.device)
        gc = _to_device(gather_col, self.device)
        return self._run(n_words, q_idx, edge_src, edge_dst,
                         lambda x: kernels.check_gather(x, gi, gc))

    def lookup_packed_T_device(self, slot_offset: int, slot_length: int,
                               q_idx, n_words: int, edge_src,
                               edge_dst) -> tuple:
        """Packed lookup words, transposed on device: (int32 [n_words,
        slot_length] device tensor, trace); bit b of word row w is query
        column 32 * w + b (the reference returns the same answers as a
        bool [B, L] bitmap)."""
        return self._run(n_words, q_idx, edge_src, edge_dst,
                         lambda x: kernels.lookup_T(x, slot_offset,
                                                    slot_length))
