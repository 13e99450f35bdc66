"""Carry the reference package's compiled state into the torch port.

This system has no weights: its state is the compiled graph — the
GraphProgram (state layout, permission program, wildcard terms) and the
fixed-fanin gather tables built from it.  `from_reference` takes those as
the reference package produced them and returns the port's program, its
device tables and a kernel cache over them, so the two packages can be
run on the very same tables.  `segment_from_reference` does the same for
the segment kernel's padded edge arrays, and `leopard_from_reference`
for a Leopard closure index (its fragments' host arrays, uploaded as the
port's planes).

The reference objects are read by attribute name only (duck typing): this
module imports nothing of the reference package.  Arrays may be numpy or
anything `np.asarray` accepts (e.g. jax arrays).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .ops.ell import EllKernelCache
from .ops.leopard import LeopardIndex, _Fragment
from .ops.spmv import KernelCache as SegmentKernelCache
from .ops.graph_compile import (
    GraphProgram,
    PermOp,
    PExclude,
    PIntersect,
    PRead,
    PUnion,
    PZero,
    WildcardTerm,
)


def _expr(e):
    """Translate one reference permission-expression node by class name."""
    kind = type(e).__name__
    if kind == "PRead":
        return PRead(int(e.offset), int(e.length))
    if kind == "PZero":
        return PZero(int(e.length))
    if kind == "PUnion":
        return PUnion(tuple(_expr(c) for c in e.children))
    if kind == "PIntersect":
        return PIntersect(tuple(_expr(c) for c in e.children))
    if kind == "PExclude":
        return PExclude(_expr(e.base), _expr(e.subtract))
    raise TypeError(f"unknown reference expression node {kind}")


def program_from_reference(ref) -> GraphProgram:
    """The port's GraphProgram with the reference program's fields."""
    return GraphProgram(
        state_size=int(ref.state_size),
        edge_src=np.asarray(ref.edge_src, np.int32),
        edge_dst=np.asarray(ref.edge_dst, np.int32),
        cav_src=np.asarray(ref.cav_src, np.int32),
        cav_dst=np.asarray(ref.cav_dst, np.int32),
        caveats_device_ok=bool(ref.caveats_device_ok),
        perm_ops=[PermOp(int(op.offset), int(op.length), _expr(op.expr))
                  for op in ref.perm_ops],
        wildcard_terms=[WildcardTerm(int(t.self_offset), int(t.self_length),
                                     tuple(int(i) for i in t.mask_indices))
                        for t in ref.wildcard_terms],
        arrow_specs={k: list(v) for k, v in ref.arrow_specs.items()},
        num_objects=dict(ref.num_objects),
        object_ids={t: list(v) for t, v in ref.object_ids.items()},
        object_index={t: dict(v) for t, v in ref.object_index.items()},
        slot_offsets=dict(ref.slot_offsets),
        suggested_iterations=int(ref.suggested_iterations),
    )


def from_reference(ref_prog, idx_main, idx_aux, stages: Optional[tuple] = None,
                   tree_depth: int = 0, shared_tree_depth: Optional[int] = None,
                   num_iters: Optional[int] = None, device=None) -> tuple:
    """(program, device idx_main, device idx_aux, EllKernelCache) running
    the reference's tables.  `stages` is the reference kernel cache's
    `stages` (computed here from the program when None); `tree_depth` and
    `shared_tree_depth` are the reference EllTables' / kernel cache's, so
    aux passes and the iteration cap match too."""
    dev = resolve_device(device)
    prog = program_from_reference(ref_prog)
    main = np.ascontiguousarray(np.asarray(idx_main), np.int32)
    aux = np.ascontiguousarray(np.asarray(idx_aux), np.int32)
    if stages is not None:
        stages = tuple((tuple((int(lo), int(hi)) for lo, hi in ranges),
                        int(repeat), bool(wants_aux))
                       for ranges, repeat, wants_aux in stages)
    kernel = EllKernelCache(prog, n_aux_rows=aux.shape[0],
                            tree_depth=tree_depth, device=dev,
                            num_iters=num_iters,
                            shared_tree_depth=shared_tree_depth,
                            host_main=main, host_aux=aux, stages=stages)
    return (prog, torch.from_numpy(main).to(dev), torch.from_numpy(aux).to(dev),
            kernel)


def segment_from_reference(ref_graph, prog: Optional[GraphProgram] = None,
                           num_iters: Optional[int] = None,
                           device=None) -> tuple:
    """(device edge_src, device edge_dst, free list, positions,
    segment KernelCache) from a reference _SegmentGraph: the padded edge
    arrays, the free positions in pop order and each tuple key's edge
    positions, and a port kernel cache over `prog` (the reference
    graph's program carried across when None)."""
    dev = resolve_device(device)
    prog = prog if prog is not None else program_from_reference(
        ref_graph.prog)
    src = np.array(np.asarray(ref_graph.edge_src), np.int32)
    dst = np.array(np.asarray(ref_graph.edge_dst), np.int32)
    return (torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
            [int(p) for p in ref_graph.free],
            {k: [int(p) for p in v] for k, v in ref_graph.positions.items()},
            SegmentKernelCache(prog, dev, num_iters=num_iters))


def leopard_from_reference(ref_index, prog: GraphProgram,
                           device=None) -> LeopardIndex:
    """A port LeopardIndex carrying a reference index's statuses and
    fragments (`local_of`, `col_of`, `state`, `seeds`, the `base_*`
    edges, `perm_ops_local`, `perm_lo`, `plane_rows`, the keyed edges
    and the flags), each fragment's closure rows uploaded as a plane."""
    idx = LeopardIndex(prog, resolve_device(device))
    idx.statuses = dict(ref_index.statuses)
    for f in ref_index._frags:
        frag = _Fragment(
            pair=tuple(f.pair), slots=tuple(f.slots),
            subject_types=tuple(f.subject_types),
            local_of=np.array(f.local_of, np.int32),
            col_of=np.array(f.col_of, np.int32),
            n_rows=int(f.n_rows), n_cols=int(f.n_cols), words=int(f.words),
            state=np.array(f.state, np.uint32),
            seeds=np.array(f.seeds, np.uint32),
            base_src=np.array(f.base_src, np.int32),
            base_dst=np.array(f.base_dst, np.int32),
            base_alive=np.array(f.base_alive, bool),
            perm_ops_local=tuple((int(lo), int(n), tuple(int(x) for x in s))
                                 for lo, n, s in f.perm_ops_local),
            perm_lo=int(f.perm_lo), plane_rows=int(f.plane_rows),
            key_edges={k: [tuple(e) for e in v]
                       for k, v in f.key_edges.items()},
            live=bool(f.live), quarantined=bool(f.quarantined),
            retired=bool(f.retired), reason=str(f.reason), seq=int(f.seq))
        idx._upload_plane(frag)
        idx._frags.append(frag)
        idx._by_pair[frag.pair] = frag
    return idx
