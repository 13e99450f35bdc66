"""Collectives of the mesh path, in one process and across processes.

The reference's sharded programs run under `shard_map` and join their
shards with `lax.all_gather(tiled=True)`, `lax.pmax` and `lax.psum`.  In
one process the port drives every shard, so its collectives are copies
between the shards' buffers, writes that kernels make into several
replicas at once, and one small kernel:

- `all_gather_rows`: a tiled all_gather along `graph` — each replica's
  row block reaches every peer replica.  On the sharded ELL sweep the
  gather that computes a block writes it into every replica on its card
  (the mesh_* kernels), so only peers on another card get a copy
  (`written=True`); otherwise every block is copied (`Tensor.copy_` on
  row slices: `cudaMemcpyAsync` on one card, a peer copy across cards,
  ordered by torch against both devices' current streams);
- `or_allreduce`: a boolean all-reduce along `graph` — one `or_combine`
  launch ORs the replicas that share a card and writes the result into
  each; a peer on another card is copied in first and the result copied
  back to it;
- `reduce_sweep_deltas`: the convergence flag ORed over every shard and
  the changed-bit count summed over the `data` shards only (the state is
  replicated along `graph`; summing over it too would multiply the count
  by its size, reference parallel/sharding.py:548-552);
  `reduce_data_deltas` the same from one (count, changed) row a data
  shard, read back in one transfer.

On a mesh across processes (sharding.make_process_mesh) the blocks held
by other ranks go over `torch.distributed` (NCCL for card tensors, gloo
for CPU ones) on the data shard's graph-axis group (`link`):

- `all_gather_rows`: one `all_gather_into_tensor` from this rank's run of
  blocks straight into the lead replica's rows (in place: the run is the
  rank's own chunk of the output); a column half (the maybe plane) is
  not contiguous and is staged through a [rows, half] buffer; co-located
  replicas then copy the blocks that came in;
- `or_allreduce`: NCCL has no bitwise-OR reduction, so the co-located
  partials are ORed (`or_combine`), the rank's result all-gathered, and
  one more `or_combine` ORs the gathered partials into every local one;
- `reduce_data_deltas(across=True)`: one all-reduce (sum) of the [D, 2]
  pairs over the world — each data shard's pair written by its owner
  only, the changed flags summed as an OR — then the one readback;
- `sum_across`: the readout's all-reduce, every rank's answer rows
  summed into the whole answer (each row written by one rank, zero
  elsewhere).

Every collective runs on the tensors' current stream order (a blocking
`torch.distributed` call makes the current stream wait for it), which is
where the kernels launch.

`COLLECTIVES` counts the calls, the bytes each collective delivered and
the copies it made since the last `reset_collectives()`, on every device
(the CPU included), so a run can hold the bytes a sweep moves against
`sharding.comm_model` whether they moved by copy, by a kernel's write or
from another rank; `xrank_calls` and `xrank_bytes` count, apart, the
`torch.distributed` calls and the bytes that arrived from other ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels

COLLECTIVES: dict = {name: {"calls": 0, "bytes": 0, "copies": 0,
                            "xrank_calls": 0, "xrank_bytes": 0}
                     for name in ("all_gather_rows", "or_allreduce",
                                  "reduce_sweep_deltas", "sum_across")}


def reset_collectives() -> None:
    for c in COLLECTIVES.values():
        for key in c:
            c[key] = 0


def _count(name: str, nbytes: int, copies: int = 0, xcalls: int = 0,
           xbytes: int = 0) -> None:
    c = COLLECTIVES[name]
    c["calls"] += 1
    c["bytes"] += nbytes
    c["copies"] += copies
    c["xrank_calls"] += xcalls
    c["xrank_bytes"] += xbytes


def _dist():
    import torch.distributed as dist

    return dist


def all_gather_rows(replicas: list, lo: int, hi: int, cols: tuple = None,
                    written: bool = False, link=None) -> None:
    """Rows [lo, hi) of the replicas (one data shard's graph replicas,
    [rows, words] each) split into len(replicas) equal blocks, block g
    owned by replicas[g]: each block reaches every peer.  `cols` = (a, b)
    moves only words [a, b) of each row (the maybe plane).  `written`:
    the kernel that computed block g already wrote it into every replica
    on replicas[g]'s device, so only peers on other devices get a copy.
    `link` (a sharding.GraphLink): the replicas of other ranks are None
    here and their blocks come over `torch.distributed`.
    The bytes counted are every block into every (local) peer, by copy
    or not."""
    n = len(replicas)
    if n == 1:
        return
    if (hi - lo) % n:
        raise ValueError(f"rows [{lo}, {hi}) do not split into {n} blocks")
    b = (hi - lo) // n
    if link is not None:
        _all_gather_rows_across(replicas, lo, hi, b, cols, written, link)
        return
    moved = copies = 0
    for g, src in enumerate(replicas):
        blk = src[lo + g * b: lo + (g + 1) * b]
        if cols is not None:
            blk = blk[:, cols[0]: cols[1]]
        for j, dst in enumerate(replicas):
            if j == g:
                continue
            moved += blk.numel() * blk.element_size()
            if written and dst.device == src.device:
                continue
            out = dst[lo + g * b: lo + (g + 1) * b]
            if cols is not None:
                out = out[:, cols[0]: cols[1]]
            out.copy_(blk)
            copies += 1
    _count("all_gather_rows", moved, copies)


def _all_gather_rows_across(replicas: list, lo: int, hi: int, b: int,
                            cols, written: bool, link) -> None:
    """`all_gather_rows` on a mesh across processes: this rank holds
    replicas [g0, g0 + k) of the data shard (all on its card, every one
    already holding blocks [g0, g0 + k) by the kernels' writes)."""
    if not written:
        raise ValueError("a mesh across processes gathers only blocks the "
                         "kernels wrote into every co-located replica")
    n = len(replicas)
    local = [r for r in replicas if r is not None]
    lead = local[0]
    g0, k = link.g0, link.k
    a, z = cols if cols is not None else (0, lead.shape[1])
    blk_bytes = b * (z - a) * lead.element_size()
    moved = len(local) * (n - 1) * blk_bytes
    if link.group is None:
        _count("all_gather_rows", moved)
        return
    mine = (lo + g0 * b, lo + (g0 + k) * b)
    copies = 0
    if cols is None:
        # in place: this rank's run is its own chunk of the output rows
        _dist().all_gather_into_tensor(lead[lo:hi], lead[mine[0]:mine[1]],
                                       group=link.group)
    else:
        stage = torch.empty((hi - lo, z - a), dtype=lead.dtype,
                            device=lead.device)
        stage[g0 * b:(g0 + k) * b].copy_(lead[mine[0]:mine[1], a:z])
        _dist().all_gather_into_tensor(stage, stage[g0 * b:(g0 + k) * b],
                                       group=link.group)
        lead[lo:hi, a:z].copy_(stage)
        copies += 2
    # the co-located replicas take the blocks that came in from the lead
    for r in local[1:]:
        for s0, s1 in ((lo, mine[0]), (mine[1], hi)):
            if s1 > s0:
                r[s0:s1, a:z].copy_(lead[s0:s1, a:z])
                copies += 1
    _count("all_gather_rows", moved, copies, xcalls=1,
           xbytes=(n - k) * blk_bytes)


def or_allreduce(partials: list, impl=kernels, link=None) -> None:
    """partials[g] |= every peer's partial, in place, for one data shard's
    graph replicas: `impl.or_combine` (the kernel, or its twin) over the
    replicas on partials[0]'s device and a copy, next to them, of each
    peer on another device; then the result is copied back to those
    peers.  One launch, and no copy between co-located replicas, up to
    MAX_OR_PARTS replicas; past that, each further group of peers is
    combined with partials[0] in its own launch and the earlier groups
    get the final result by copy.  The bytes counted are each peer's
    partial in and the result out to each peer: 2 (G - 1) partials.
    `link` (a sharding.GraphLink): the partials of other ranks are None
    here and come over `torch.distributed`."""
    n = len(partials)
    if n == 1:
        return
    if link is not None:
        _or_allreduce_across(partials, impl, link)
        return
    root = partials[0]
    far = [p for p in partials[1:] if p.device != root.device]
    peers = ([p for p in partials[1:] if p.device == root.device]
             + [p.to(root.device) for p in far])
    step = kernels.MAX_OR_PARTS - 1
    groups = [peers[i: i + step] for i in range(0, len(peers), step)]
    for grp in groups:
        impl.or_combine([root] + grp)
    for grp in groups[:-1]:
        for p in grp:
            p.copy_(root)
    for p in far:
        p.copy_(root)
    _count("or_allreduce", 2 * (n - 1) * root.numel() * root.element_size())


def _or_allreduce_across(partials: list, impl, link) -> None:
    """`or_allreduce` on a mesh across processes: the co-located partials
    ORed into each other (one `or_combine`), this rank's result gathered
    from every member rank (NCCL has no bitwise-OR reduction), then one
    more `or_combine` ORs the other ranks' into every local partial."""
    local = [p for p in partials if p is not None]
    if len(local) + len(link.members) - 1 > kernels.MAX_OR_PARTS:
        raise ValueError(f"{len(partials)} graph replicas over "
                         f"{len(link.members)} ranks exceed "
                         f"{kernels.MAX_OR_PARTS} parts a combine")
    root = local[0]
    nbytes = root.numel() * root.element_size()
    if len(local) > 1:
        impl.or_combine(local)
    if link.group is None:
        _count("or_allreduce", 2 * (len(local) - 1) * nbytes)
        return
    rows = root.shape[0]
    stage = torch.empty((len(link.members) * rows,) + tuple(root.shape[1:]),
                        dtype=root.dtype, device=root.device)
    _dist().all_gather_into_tensor(stage, root, group=link.group)
    me = link.members.index(_dist().get_rank())
    impl.or_combine(local + [stage[i * rows:(i + 1) * rows]
                             for i in range(len(link.members)) if i != me])
    n_far = len(link.members) - 1
    _count("or_allreduce", 2 * (len(partials) - 1) * nbytes, xcalls=1,
           xbytes=n_far * nbytes)


def reduce_sweep_deltas(deltas: list, mesh=None) -> tuple:
    """One sweep's per-shard `sweep_delta` pairs ([D][G] int32 [2]
    tensors: changed-bit count, any change) -> (global count as int32,
    changed anywhere).  One readback for the whole mesh.  On a `mesh`
    across processes (other ranks' pairs None here) each data shard's
    owner puts its pair in a [D, 2] row and one all-reduce sums them."""
    if mesh is not None and mesh.spans_processes:
        rows = torch.zeros((len(deltas), 2), dtype=torch.int32,
                           device=mesh.devices[0][0])
        for d, row in enumerate(deltas):
            if mesh.owner(d) == mesh.rank:
                rows[d] = next(t for t in row if t is not None)
        return reduce_data_deltas(rows, [], across=True)
    flat = [t for row in deltas for t in row]
    dev = flat[0].device
    vals = torch.stack([t.to(dev) for t in flat]).tolist()
    n_graph = len(deltas[0])
    count = sum(vals[d * n_graph][0] for d in range(len(deltas)))
    changed = any(v[1] for v in vals)
    _count("reduce_sweep_deltas", 8 * len(flat))
    return int(np.int64(count).astype(np.int32)), changed


def reduce_data_deltas(rows: torch.Tensor, slots: list,
                       across: bool = False) -> tuple:
    """One sharded ELL sweep's (changed-bit count, any change) pairs ->
    (count summed over the data shards as int32, changed anywhere).
    `rows` is int32 [D, 2] on the first shard's device, row d data shard
    d's pair; `slots[d]` is where that pair was written, copied into
    rows[d] when it lies on another device.  `across`: a mesh across
    processes, where each rank wrote the rows of the data shards it owns
    (zeros elsewhere) and one all-reduce sums them over the world.  One
    readback."""
    for d, slot in enumerate(slots):
        if slot.device != rows.device:
            rows[d].copy_(slot)
    nbytes = rows.numel() * rows.element_size()
    xcalls = xbytes = 0
    if across:
        _dist().all_reduce(rows)
        xcalls, xbytes = 1, (_dist().get_world_size() - 1) * nbytes
    vals = rows.tolist()
    count = sum(v[0] for v in vals)
    _count("reduce_sweep_deltas", nbytes, xcalls=xcalls, xbytes=xbytes)
    return int(np.int64(count).astype(np.int32)), any(v[1] for v in vals)


def sum_across(t: torch.Tensor) -> None:
    """All-reduce (sum) of `t` over the world, in place: the readout of a
    mesh across processes, where each element is written by one rank and
    zero on the others."""
    n = _dist().get_world_size()
    nbytes = t.numel() * t.element_size()
    _dist().all_reduce(t)
    _count("sum_across", nbytes, xcalls=1, xbytes=(n - 1) * nbytes)